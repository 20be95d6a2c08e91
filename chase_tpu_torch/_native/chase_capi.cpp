// libchase_tpu_torch — C ABI with the reference's symbol names and
// signatures (interface/chase_c_interface.h: {s,d,c,z}chase_init_,
// *chase_, *chase_get_eigenpairs_, *chase_finalize_, chase_set_*,
// chase_has_*, *readHam_/*wrtHam_, the p* families), implemented by
// embedding CPython and driving chase_tpu_torch.interface.  It exports
// the same symbol table as the JAX package's
// libchase_tpu.so (chase_tpu/_native/chase_capi.cpp), so a C or Fortran
// application (FLEUR-, YAMBO-style call patterns; the Fortran module
// interface/chase_tpu_fortran.f90) links against either unchanged.
//
// Device: CHASE_TPU_PLATFORM=cpu solves on the CPU; anything else on the
// CUDA card, and without one init fails.  The p*chase_init* entry points
// run on a torch.distributed process group, one process per rank, made
// from the launcher's RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT (NCCL
// on cards, gloo under CHASE_TPU_PLATFORM=cpu; the MPI communicator
// argument is ignored), every rank calling each entry point.  With the
// whole matrix on every rank ((m, n) = (N, N), and the block-cyclic forms)
// each rank keeps its block of it; with a smaller (m, n) each passes only
// its local block (interface.init_dist_local) and gets its own rows of the
// eigenvectors back.  A dim0 x dim1 grid must be the whole group, and a
// 1x1 grid is the one-device solve.  A call that raises in Python prints the
// traceback and the entry point's name to stderr and ends the process with
// exit code 1: the C entry points return nothing, so there is no quiet way
// to report a failure (the reference's C++ exceptions terminate too).
//
// Build (chase_tpu_torch._native.build_capi does this into build/):
//   g++ -O3 -shared -fPIC -std=c++17 chase_capi.cpp \
//       $(python3-config --includes) $(python3-config --ldflags --embed) \
//       -o libchase_tpu_torch.so
// Run a program linked against it with the repository (and, for a virtual
// environment's Python, its site-packages) on PYTHONPATH.

#include <Python.h>

#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

PyObject* g_ns = nullptr;   // namespace dict of the embedded prelude

const char* kPrelude = R"PY(
import ctypes, os
import numpy as np
import chase_tpu_torch
import chase_tpu_torch.interface as _iface
import chase_tpu_torch.io as _io

_DEVICE = 'cpu' if os.environ.get('CHASE_TPU_PLATFORM') == 'cpu' else 'cuda'
_state = {}

def _view(ptr, rows, cols, ld, dt):
    # the caller's column-major (rows, cols) buffer with leading dim ld
    dt = np.dtype(dt)
    buf = (ctypes.c_char * (ld * cols * dt.itemsize)).from_address(ptr)
    return np.frombuffer(buf, dtype=dt).reshape(cols, ld).T[:rows]

def _vector(ptr, n, dt):
    dt = np.dtype(dt)
    buf = (ctypes.c_char * (n * dt.itemsize)).from_address(ptr)
    return np.frombuffer(buf, dtype=dt)

def _buffers(ptrV, ptrR, rows, nev, nex, dt, rdt, pseudo):
    # copies of the caller's V (rows x cols) and ritzv buffers, or None
    cols = 2 * (nev + nex) if pseudo else nev + nex
    V = _view(ptrV, rows, cols, rows, dt).copy() if ptrV else None
    R = _vector(ptrR, cols, rdt).astype('float64') if ptrR else None
    return V, R

def capi_init(ptrH, ptrV, ptrR, N, nev, nex, ldh, dt, rdt, pseudo):
    # H NULL: no matrix yet, *chase_readHam_ supplies it
    H = _view(ptrH, N, N, ldh, dt) if ptrH else None
    V, R = _buffers(ptrV, ptrR, N, nev, nex, dt, rdt, pseudo)
    if pseudo:
        _iface.init_pseudo(N, nev, nex, H, V, device=_DEVICE)
        _iface._require().ritzv0 = R
    else:
        _iface.init(N, nev, nex, H, V, R, device=_DEVICE)
    _state.update(ptrV=ptrV, ptrR=ptrR, dt=dt, rdt=rdt, N=N, nev=nev)
    return 0

def capi_init_dist(ptrH, ptrV, ptrR, N, nev, nex, m, n, ldh, dt, rdt,
                   pseudo, dim0, dim1, major, mb, nb, irsrc, icsrc):
    # p*chase_init*: the reference's ranks pass their LOCAL (m, n) block of
    # a dim0 x dim1 grid (chase_c_interface.h:61-157); mb > 0 selects the
    # block-cyclic layout.  Every rank of the process group calls this.
    gs = (dim0, dim1)
    if m != N or n != N:
        # per rank: this rank's block, one process per rank of the
        # launcher's group (interface._grid_for makes the group from it)
        if mb > 0:
            raise ValueError('per-rank block-cyclic init is not supported '
                             '(use the block-block p*chase_init_)')
        H = _view(ptrH, m, n, ldh, dt)
        V, R = _buffers(ptrV, ptrR, m, nev, nex, dt, rdt, pseudo)
        _iface.init_dist_local(N, nev, nex, m, n, H, V, R, grid_shape=gs,
                               grid_major=major, pseudo=bool(pseudo),
                               device=_DEVICE)
    else:
        H = _view(ptrH, N, N, ldh, dt)
        V, R = _buffers(ptrV, ptrR, N, nev, nex, dt, rdt, pseudo)
        if mb > 0:
            _iface.init_blockcyclic(N, nev, nex, mb, nb, H, V,
                                    None if pseudo else R,
                                    pseudo=bool(pseudo), grid_shape=gs,
                                    grid_major=major, irsrc=irsrc,
                                    icsrc=icsrc, device=_DEVICE)
        elif pseudo:
            _iface.init_pseudo(N, nev, nex, H, V, distributed=True,
                               grid_shape=gs, grid_major=major,
                               device=_DEVICE)
        else:
            _iface.init(N, nev, nex, H, V, R, distributed=True,
                        grid_shape=gs, grid_major=major, device=_DEVICE)
        if pseudo:
            _iface._require().ritzv0 = R
    _state.update(ptrV=ptrV, ptrR=ptrR, dt=dt, rdt=rdt, N=N, nev=nev)
    return 0

def capi_solve(deg, tol, mode, opt, qr):
    return _iface.solve(deg if deg > 0 else None, tol if tol > 0 else None,
                        mode, opt, qr)

def capi_get(ptrV, ld, ptrR):
    # collective on a grid; the per-rank mode writes this rank's (m, nev)
    # rows.  The vectors come back Fortran-ordered (transposed where V
    # lies), so the host writes whole columns of the caller's buffer.
    evals, evecs = _iface.get_eigenpairs()
    rows, nev = evecs.shape
    ptrV = ptrV or _state['ptrV']
    ptrR = ptrR or _state['ptrR']
    if ptrV:
        _view(ptrV, rows, nev, ld if ld > 0 else rows, _state['dt'])[:] = \
            evecs
    if ptrR:
        _vector(ptrR, nev, _state['rdt'])[:] = evals
    return 0

def capi_finalize(flag):
    return _iface.finalize(flag)

def capi_set(name, value):
    getattr(_iface, 'set_' + name)(value)
    return 0

def capi_set_lanczos(lanczos_iter, num_lanczos):
    c = _iface._require().config
    _iface.set_lanczos(c.lanczos_iter if lanczos_iter < 0 else lanczos_iter,
                       c.num_lanczos if num_lanczos < 0 else num_lanczos)
    return 0

def capi_sym_check(flag):
    _iface.enable_sym_check(flag)
    return 0

def capi_read_ham(path):
    s = _iface._require()
    _iface.set_matrix(_io.load_matrix(path, s.N, _state['dt']))
    return 0

def capi_write_ham(path):
    s = _iface._require()
    if s.op is None:
        raise RuntimeError('no matrix bound to write')
    _io.save_matrix(s.op.H, path)
    return 0

def capi_print_config():
    import torch
    from chase_tpu_torch.ops.ring_hemm import LAUNCHES
    card = (torch.cuda.get_device_name(0) if _DEVICE == 'cuda'
            and torch.cuda.is_available() else 'no card')
    launches = LAUNCHES['ring_hemm']
    print(f'chase_tpu_torch {chase_tpu_torch.__version__}: PyTorch '
          f'{torch.__version__}, device {_DEVICE} ({card}); C ABI via '
          f'embedded Python; ring_hemm launches in this process: '
          f'{launches}', flush=True)
    return 0
)PY";

[[noreturn]] void fail(const char* what) {
    PyErr_Print();
    fprintf(stderr, "chase_tpu_torch C ABI: %s failed; exiting\n", what);
    fflush(stderr);
    std::exit(1);
}

void ensure_py() {
    if (g_ns) return;
    if (!Py_IsInitialized()) Py_InitializeEx(0);
    PyObject* main_mod = PyImport_AddModule("__main__");
    if (!main_mod) fail("Python start-up");
    PyObject* ns = PyModule_GetDict(main_mod);
    PyObject* r = PyRun_String(kPrelude, Py_file_input, ns, ns);
    if (!r) fail("import of chase_tpu_torch");
    Py_DECREF(r);
    Py_INCREF(ns);
    g_ns = ns;
}

// Call the prelude's function `fn` with the arguments Py_BuildValue makes
// of `fmt` (a tuple format) and the varargs; its int result.
int call(const char* fn, const char* fmt, ...) {
    ensure_py();
    PyObject* f = PyDict_GetItemString(g_ns, fn);   // borrowed
    if (!f) fail(fn);
    va_list ap;
    va_start(ap, fmt);
    PyObject* args = Py_VaBuildValue(fmt, ap);
    va_end(ap);
    if (!args) fail(fn);
    PyObject* r = PyObject_CallObject(f, args);
    Py_DECREF(args);
    if (!r) fail(fn);
    long v = PyLong_Check(r) ? PyLong_AsLong(r) : 0;
    Py_DECREF(r);
    return static_cast<int>(v);
}

unsigned long long addr(const void* p) {
    return static_cast<unsigned long long>(reinterpret_cast<uintptr_t>(p));
}

void do_init(const void* H, const void* V, const void* ritzv, int N, int nev,
             int nex, int ldh, const char* dt, const char* rdt, int pseudo) {
    call("capi_init", "(KKKiiiissi)", addr(H), addr(V), addr(ritzv), N, nev,
         nex, ldh, dt, rdt, pseudo);
}

// distributed init with the reference's full signature: (m, n) local block
// dims, (dim0, dim1) grid, grid_major ('R' | 'C'), ignored MPI
// communicator; mb/nb > 0 selects the block-cyclic layout, whose forms
// pass the whole (N, N) and their source offsets (chase_c_interface.h:
// 61-157)
void do_init_dist(const void* H, const void* V, const void* ritzv, int N,
                  int nev, int nex, int m, int n, int ldh, const char* dt,
                  const char* rdt, int pseudo, int dim0, int dim1,
                  char major, int mb, int nb, int irsrc, int icsrc) {
    call("capi_init_dist", "(KKKiiiiiissiiiCiiii)", addr(H), addr(V),
         addr(ritzv), N, nev, nex, m, n, ldh, dt, rdt, pseudo, dim0, dim1,
         (int)major, mb, nb, irsrc, icsrc);
}

}  // namespace

#define INIT_FN(prefix, T, DT, RDT, PSEUDO)                                 \
    extern "C" void prefix(int* N, int* nev, int* nex, T* H, int* ldh,      \
                           T* V, RDT_TYPE* ritzv, int* init) {              \
        (void)init;                                                         \
        do_init(H, V, ritzv, *N, *nev, *nex, *ldh, DT, RDT, PSEUDO);        \
    }

// serial init without user-provided V/ritzv: the library allocates the
// search space; eigenpairs come back through the caller's buffers in
// *chase_get_eigenpairs_ (chase_c_interface.h:25-32, 49-55).  H may be
// NULL when *chase_readHam_ supplies the matrix.
#define INIT_INT_FN(prefix, T, DT, RDT, PSEUDO)                             \
    extern "C" void prefix(int* N, int* nev, int* nex, T* H, int* ldh,      \
                           int* init) {                                     \
        (void)init;                                                         \
        do_init(H, nullptr, nullptr, *N, *nev, *nex, *ldh, DT, RDT,         \
                PSEUDO);                                                    \
    }

// distributed block-block init (chase_c_interface.h:126-157)
#define PINIT_FN(prefix, T, DT, RDT, PSEUDO)                                \
    extern "C" void prefix(int* N, int* nev, int* nex, int* m, int* n,      \
                           T* H, int* ldh, T* V, RDT_TYPE* ritzv,           \
                           int* dim0, int* dim1, char* grid_major,          \
                           void* comm, int* init) {                         \
        (void)comm; (void)init;                                             \
        do_init_dist(H, V, ritzv, *N, *nev, *nex, *m, *n, *ldh, DT, RDT,    \
                     PSEUDO, *dim0, *dim1,                                  \
                     grid_major ? *grid_major : 'R', 0, 0, 0, 0);           \
    }

#define PINIT_INT_FN(prefix, T, DT, RDT, PSEUDO)                            \
    extern "C" void prefix(int* N, int* nev, int* nex, int* m, int* n,      \
                           T* H, int* ldh, int* dim0, int* dim1,            \
                           char* grid_major, void* comm, int* init) {       \
        (void)comm; (void)init;                                             \
        do_init_dist(H, nullptr, nullptr, *N, *nev, *nex, *m, *n, *ldh,     \
                     DT, RDT, PSEUDO, *dim0, *dim1,                         \
                     grid_major ? *grid_major : 'R', 0, 0, 0, 0);           \
    }

// distributed block-cyclic init (mbsize x nbsize ScaLAPACK-style blocks;
// irsrc/icsrc source offsets) (chase_c_interface.h:61-121)
#define PINIT_BC_FN(prefix, T, DT, RDT, PSEUDO)                             \
    extern "C" void prefix(int* N, int* nev, int* nex, int* mbsize,         \
                           int* nbsize, T* H, int* ldh, T* V,               \
                           RDT_TYPE* ritzv, int* dim0, int* dim1,           \
                           char* grid_major, int* irsrc, int* icsrc,        \
                           void* comm, int* init) {                         \
        (void)comm; (void)init;                                             \
        do_init_dist(H, V, ritzv, *N, *nev, *nex, *N, *N, *ldh, DT, RDT,    \
                     PSEUDO, *dim0, *dim1,                                  \
                     grid_major ? *grid_major : 'R', *mbsize, *nbsize,      \
                     irsrc ? *irsrc : 0, icsrc ? *icsrc : 0);               \
    }

#define PINIT_BC_INT_FN(prefix, T, DT, RDT, PSEUDO)                         \
    extern "C" void prefix(int* N, int* nev, int* nex, int* mbsize,         \
                           int* nbsize, T* H, int* ldh, int* dim0,          \
                           int* dim1, char* grid_major, int* irsrc,         \
                           int* icsrc, void* comm, int* init) {             \
        (void)comm; (void)init;                                             \
        do_init_dist(H, nullptr, nullptr, *N, *nev, *nex, *N, *N, *ldh,     \
                     DT, RDT, PSEUDO, *dim0, *dim1,                         \
                     grid_major ? *grid_major : 'R', *mbsize, *nbsize,      \
                     irsrc ? *irsrc : 0, icsrc ? *icsrc : 0);               \
    }

#define RDT_TYPE float
INIT_FN(schase_init_, float, "float32", "float32", 0)
INIT_FN(cchase_init_, void, "complex64", "float32", 0)
INIT_FN(cchase_init_pseudo_, void, "complex64", "float32", 1)
INIT_INT_FN(schase_init_internal_, float, "float32", "float32", 0)
INIT_INT_FN(cchase_init_internal_, void, "complex64", "float32", 0)
INIT_INT_FN(cchase_init_pseudo_internal_, void, "complex64", "float32", 1)
PINIT_FN(pschase_init_, float, "float32", "float32", 0)
PINIT_FN(pcchase_init_, void, "complex64", "float32", 0)
PINIT_FN(pcchase_init_pseudo_, void, "complex64", "float32", 1)
PINIT_INT_FN(pschase_init_internal_, float, "float32", "float32", 0)
PINIT_INT_FN(pcchase_init_internal_, void, "complex64", "float32", 0)
PINIT_INT_FN(pcchase_init_pseudo_internal_, void, "complex64", "float32", 1)
PINIT_BC_FN(pschase_init_blockcyclic_, float, "float32", "float32", 0)
PINIT_BC_FN(pcchase_init_blockcyclic_, void, "complex64", "float32", 0)
PINIT_BC_FN(pcchase_init_pseudo_blockcyclic_, void, "complex64", "float32", 1)
PINIT_BC_INT_FN(pschase_init_blockcyclic_internal_, float, "float32",
                "float32", 0)
PINIT_BC_INT_FN(pcchase_init_blockcyclic_internal_, void, "complex64",
                "float32", 0)
PINIT_BC_INT_FN(pcchase_init_pseudo_blockcyclic_internal_, void, "complex64",
                "float32", 1)
#undef RDT_TYPE
#define RDT_TYPE double
INIT_FN(dchase_init_, double, "float64", "float64", 0)
INIT_FN(zchase_init_, void, "complex128", "float64", 0)
INIT_FN(zchase_init_pseudo_, void, "complex128", "float64", 1)
INIT_INT_FN(dchase_init_internal_, double, "float64", "float64", 0)
INIT_INT_FN(zchase_init_internal_, void, "complex128", "float64", 0)
INIT_INT_FN(zchase_init_pseudo_internal_, void, "complex128", "float64", 1)
PINIT_FN(pdchase_init_, double, "float64", "float64", 0)
PINIT_FN(pzchase_init_, void, "complex128", "float64", 0)
PINIT_FN(pzchase_init_pseudo_, void, "complex128", "float64", 1)
PINIT_INT_FN(pdchase_init_internal_, double, "float64", "float64", 0)
PINIT_INT_FN(pzchase_init_internal_, void, "complex128", "float64", 0)
PINIT_INT_FN(pzchase_init_pseudo_internal_, void, "complex128", "float64", 1)
PINIT_BC_FN(pdchase_init_blockcyclic_, double, "float64", "float64", 0)
PINIT_BC_FN(pzchase_init_blockcyclic_, void, "complex128", "float64", 0)
PINIT_BC_FN(pzchase_init_pseudo_blockcyclic_, void, "complex128", "float64", 1)
PINIT_BC_INT_FN(pdchase_init_blockcyclic_internal_, double, "float64",
                "float64", 0)
PINIT_BC_INT_FN(pzchase_init_blockcyclic_internal_, void, "complex128",
                "float64", 0)
PINIT_BC_INT_FN(pzchase_init_pseudo_blockcyclic_internal_, void,
                "complex128", "float64", 1)
#undef RDT_TYPE

#define SOLVE_FN(prefix, TOL_T)                                             \
    extern "C" void prefix(int* deg, TOL_T* tol, char* mode, char* opt,     \
                           char* qr) {                                      \
        call("capi_solve", "(idCCC)", deg ? *deg : 0,                       \
             tol ? (double)*tol : 0.0, (int)(mode ? *mode : 'R'),           \
             (int)(opt ? *opt : 'S'), (int)(qr ? *qr : 'C'));               \
    }

SOLVE_FN(dchase_, double)
SOLVE_FN(schase_, float)
SOLVE_FN(zchase_, double)
SOLVE_FN(cchase_, float)
SOLVE_FN(zchase_pseudo_, double)
SOLVE_FN(cchase_pseudo_, float)
SOLVE_FN(pdchase_, double)
SOLVE_FN(pschase_, float)
SOLVE_FN(pzchase_, double)
SOLVE_FN(pcchase_, float)

#define GET_FN(prefix, T, RT)                                               \
    extern "C" void prefix(T* LEigsV, int* ld, RT* ritzv) {                 \
        call("capi_get", "(KiK)", addr(LEigsV), ld ? *ld : 0, addr(ritzv)); \
    }

GET_FN(dchase_get_eigenpairs_, double, double)
GET_FN(schase_get_eigenpairs_, float, float)
GET_FN(zchase_get_eigenpairs_, void, double)
GET_FN(cchase_get_eigenpairs_, void, float)
GET_FN(pdchase_get_eigenpairs_, double, double)
GET_FN(pschase_get_eigenpairs_, float, float)
GET_FN(pzchase_get_eigenpairs_, void, double)
GET_FN(pcchase_get_eigenpairs_, void, float)

#define FIN_FN(prefix)                                                      \
    extern "C" void prefix(int* flag) {                                     \
        call("capi_finalize", "(i)", flag ? *flag : 0);                     \
    }

FIN_FN(dchase_finalize_)
FIN_FN(schase_finalize_)
FIN_FN(zchase_finalize_)
FIN_FN(cchase_finalize_)
FIN_FN(pdchase_finalize_)
FIN_FN(pschase_finalize_)
FIN_FN(pzchase_finalize_)
FIN_FN(pcchase_finalize_)

#define HAM_FN(prefix, FN)                                                  \
    extern "C" void prefix(const char* filename) {                          \
        call(FN, "(s)", filename);                                          \
    }

HAM_FN(pdchase_readHam_, "capi_read_ham")
HAM_FN(pschase_readHam_, "capi_read_ham")
HAM_FN(pcchase_readHam_, "capi_read_ham")
HAM_FN(pzchase_readHam_, "capi_read_ham")
HAM_FN(dchase_readHam_, "capi_read_ham")
HAM_FN(schase_readHam_, "capi_read_ham")
HAM_FN(cchase_readHam_, "capi_read_ham")
HAM_FN(zchase_readHam_, "capi_read_ham")
HAM_FN(pdchase_wrtHam_, "capi_write_ham")
HAM_FN(pschase_wrtHam_, "capi_write_ham")
HAM_FN(pcchase_wrtHam_, "capi_write_ham")
HAM_FN(pzchase_wrtHam_, "capi_write_ham")

// unified config setters (chase_c_interface.h:217-230)
extern "C" void chase_set_tol_(double* tol) {
    call("capi_set", "(sd)", "tol", *tol);
}
extern "C" void chase_set_deg_(int* deg) {
    call("capi_set", "(si)", "deg", *deg);
}
extern "C" void chase_set_max_iter_(int* n) {
    call("capi_set", "(si)", "maxiter", *n);
}
extern "C" void chase_set_opt_(int* flag) {
    call("capi_set", "(si)", "opt", *flag);
}
extern "C" void chase_set_lanczos_iter_(int* n) {
    call("capi_set_lanczos", "(ii)", *n, -1);
}
extern "C" void chase_set_num_lanczos_(int* n) {
    call("capi_set_lanczos", "(ii)", -1, *n);
}
extern "C" void chase_set_max_deg_(int* n) {
    call("capi_set", "(si)", "max_deg", *n);
}
extern "C" void chase_set_deg_extra_(int* n) {
    call("capi_set", "(si)", "deg_extra", *n);
}
extern "C" void chase_set_approx_(int* flag) {
    call("capi_set", "(si)", "approx", *flag);
}
extern "C" void chase_set_cholqr_(int* flag) {
    call("capi_set", "(si)", "cholqr", *flag);
}
extern "C" void chase_enable_sym_check_(int* flag) {
    call("capi_sym_check", "(i)", *flag);
}
extern "C" void chase_set_decaying_rate_(float* rate) {
    call("capi_set", "(sd)", "decaying_rate", (double)*rate);
}
extern "C" void chase_set_cluster_aware_degrees_(int* flag) {
    call("capi_set", "(si)", "cluster_aware_degrees", *flag);
}
extern "C" void chase_set_upperb_scale_rate_(float* rate) {
    call("capi_set", "(sd)", "upperb_scale_rate", (double)*rate);
}

// build introspection (chase_c_interface.h:234-239): a CUDA build; its
// process grids run on torch.distributed (NCCL through PyTorch), not on
// MPI, ScaLAPACK or an NCCL of its own
extern "C" void chase_has_cuda_(int* flag) { *flag = 1; }
extern "C" void chase_has_nccl_(int* flag) { *flag = 0; }
extern "C" void chase_has_scalapack_(int* flag) { *flag = 0; }
extern "C" void chase_has_mpi_(int* flag) { *flag = 0; }
extern "C" void chase_has_tpu_(int* flag) { *flag = 0; }
extern "C" void chase_get_version_(char* version, int* len) {
    const char* v = "chase_tpu_torch-0.1.0";
    int n = (int)strlen(v);
    if (*len > n) {
        memcpy(version, v, n + 1);
        *len = n;
    } else {
        memcpy(version, v, *len);
    }
}
extern "C" void chase_print_config_() {
    fflush(stdout);
    call("capi_print_config", "()");
}
