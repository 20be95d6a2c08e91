"""One rank of the PyTorch port's process-grid tests.

    python tests/torch_grid_worker.py BATTERY R C RANK RENDEZVOUS OUT_DIR

Joins a gloo process group of R·C ranks through the ``file://`` rendezvous
RENDEZVOUS (``multihost.init_grid``, RANK and WORLD_SIZE from the
environment it sets), builds the (R, C) grid, runs the battery of cases
named BATTERY and writes what each case computed to OUT_DIR/rank<k>.npz
(gathered multivectors whole, so that every rank's copy can be held to
the others').  ``tests/test_torch_grid.py``,
``tests/test_torch_grid_ring.py``, ``tests/test_torch_grid_solve.py``,
``tests/test_torch_grid_pseudo.py``, ``tests/test_torch_grid_fused.py``,
``tests/test_torch_grid_ring2d.py``, ``tests/test_torch_grid_solve2d.py``,
``tests/test_torch_grid_comm.py``, ``tests/test_torch_grid_io.py``, ``tests/test_torch_grid_interface.py``
and ``tests/test_torch_cli_interface.py`` start the ranks and compare the
results with the JAX package in their own process (the I/O batteries read
the files that process wrote into OUT_DIR, and write theirs there).  This script imports torch,
numpy and the port only.  A case that raises ends the rank with exit code
1, so its peers' collectives fail instead of waiting.
"""

import os
import sys
import traceback

import numpy as np
import torch

torch.set_num_threads(1)

N_RING, K_RING = 96, 7               # ring_hemm
N_FILT, W_FILT, DEG_FILT = 96, 20, 6  # the ring filters
EIG = dict(N=128, nev=12, nex=8)     # the solves
TOL = {"float32": 1e-3, "complex64": 1e-4, "float64": 1e-9,
       "complex128": 1e-9}
BSE = dict(N=128, nev=12, nex=8)     # the BSE solves
BSE_TOL = {"float32": 1e-4, "complex64": 1e-4, "float64": 1e-9,
           "complex128": 1e-9}
N_SOPS, K_SOPS = 132, 10             # the S-ops: rows cut by 2, 3 and 4
DEGS_2D = (6, 7)                     # the 2-D rings' deg_max: even, odd
# the sharded I/O: N ragged on a (3, 1) grid, even on (2, 1), (1, 2),
# (2, 2); M the rectangular file's columns, k the checkpoint's, mb the
# block-cyclic block
IO = dict(N=130, M=40, k=10, mb=8)
IO_DTYPES = (np.float64, np.complex64)
IFACE = dict(N=64, nev=6, nex=6, tol=1e-10, mb=8)   # the interface solves
IFACE_BSE = dict(N=64, nev=4, nex=4, tol=1e-9)
DIR = None                           # OUT_DIR of this rank (main sets it)


# -- inputs (numpy, seeded; the tests rebuild them for the JAX side) -------

def problem(N, k, dtype, seed):
    """A random Hermitian H (N × N), a block X (N × k) and the filter's
    (λ₁, lower, upper): H's smallest, (k+1)-th smallest and largest
    eigenvalues."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((N, N))
    X = rng.standard_normal((N, k))
    if np.issubdtype(dtype, np.complexfloating):
        A = A + 1j * rng.standard_normal((N, N))
        X = X + 1j * rng.standard_normal((N, k))
    H = ((A + A.conj().T) / 2).astype(dtype)
    X = X.astype(dtype)
    w = np.linalg.eigvalsh(H.astype(np.complex128))
    return H, X, float(w[0]), float(w[k]), float(w[-1])


def filter_degrees(k: int = W_FILT, deg_max: int = DEG_FILT) -> np.ndarray:
    """Mixed degrees: locked columns (0), early retirees, the rest."""
    d = np.full(k, deg_max, np.int32)
    d[:3] = 0
    d[3:8] = 2
    d[8:11] = 1
    return d


# (name, problem dtype, shadow dtype or None, problem seed)
FILTER_CASES = (("f32", np.float32, None, 11),
                ("c64", np.complex64, None, 12),
                ("f64_on_f32", np.float64, "float32", 13),
                ("f32_on_bf16", np.float32, "bfloat16", 14))
# the 2-D rings add the dtypes the kernel does not take (torch.matmul)
FILTER_CASES_2D = (("f64", np.float64, None, 15),
                   ("c128", np.complex128, None, 16)) + FILTER_CASES


def bse_filter_problem(N, k, dtype, seed):
    """A random BSE H (N × N), a block X (N × k) and the H² filter's
    (μ₁, lower, upper) from H's spectrum: the smallest and (k+1)-th
    smallest λ², and 1.01·the largest."""
    from chase_tpu_torch.models import random_pseudo_hermitian
    H = random_pseudo_hermitian(N, dtype, seed=seed)
    rng = np.random.default_rng(seed + 100)
    X = rng.standard_normal((N, k))
    if np.issubdtype(dtype, np.complexfloating):
        X = X + 1j * rng.standard_normal((N, k))
    mu = np.sort(np.abs(np.linalg.eigvals(H.astype(np.complex128)).real)
                 ) ** 2
    return H, X.astype(dtype), float(mu[0]), float(mu[k]), \
        float(mu[-1] * 1.01)


def refine_h2_inputs(H, X, deg, lam1, lo, up, deg_max):
    """The H² refine filter's V (X orthonormalized), its H² residual
    vectors R2 = H²·V − V·diag(θ²) and tables from θ² = diag(Vᴴ·H²·V)."""
    from chase_tpu_torch.ops.filter import refine_tables
    Hw = H.astype(np.complex128)
    Q, _ = np.linalg.qr(X.astype(np.complex128))
    H2Q = Hw @ (Hw @ Q)
    th2 = np.real(np.einsum("ij,ij->j", Q.conj(), H2Q))
    R2 = H2Q - Q * th2
    if not np.issubdtype(H.dtype, np.complexfloating):
        Q, R2 = Q.real, R2.real
    tabs = refine_tables(th2, deg, lam1, lo, up, deg_max)
    return Q.astype(H.dtype), R2.astype(H.dtype), tabs, (up + lo) / 2.0


def refine_inputs(H, X, deg, deg_max=DEG_FILT):
    """A Ritz window V (X orthonormalized), its Ritz values and residual
    vectors R = H·V − V·diag(θ), and the refine filter's tables."""
    from chase_tpu_torch.ops.filter import refine_tables
    Hw = H.astype(np.complex128)
    Q, _ = np.linalg.qr(X.astype(np.complex128))
    theta = np.real(np.einsum("ij,ij->j", Q.conj(), Hw @ Q))
    R = Hw @ Q - Q * theta
    if not np.issubdtype(H.dtype, np.complexfloating):
        Q, R = Q.real, R.real
    w = np.linalg.eigvalsh(Hw)
    lam1, lo, up = float(w[0]), float(w[X.shape[1]]), float(w[-1])
    tabs = refine_tables(theta, deg, lam1, lo, up, deg_max)
    return Q.astype(H.dtype), R.astype(H.dtype), tabs, (up + lo) / 2.0


# -- the live suffix: windows wider than a W tile, and the full-width
# recurrence the ring filters ran before it ------------------------------

N_SUF, W_SUF, PAD_SUF = 240, 200, 24     # rows, window, degree-0 pad
DEG_SUF = 7


def suffix_degrees(kind: str, w: int = W_SUF, pad: int = PAD_SUF,
                   deg_max: int = DEG_SUF) -> np.ndarray:
    """A window's degrees: "sorted" (a pad of degree 0, then ascending
    and spread, as the solvers hand them), "unsorted" (the same
    shuffled) or "equal" (the pad, then every column deg_max)."""
    d = np.zeros(w, np.int32)
    if kind == "equal":
        d[pad:] = deg_max
        return d
    rest = w - pad
    d[pad:] = 1 + (np.arange(rest) * deg_max) // rest   # 1 … deg_max
    if kind == "unsorted":
        np.random.default_rng(5).shuffle(d)
    return d


def suffix_widths(degrees, first: int, tile: int) -> list:
    """The width of each step's product from step ``first`` on: from the
    first live column to the right edge, rounded up to whole tiles."""
    d = np.asarray(degrees)
    w, out = d.size, []
    for t in range(first, int(d.max()) + 1):
        j = int(np.flatnonzero(d >= t)[0])
        out.append(min(w, -(-(w - j) // tile) * tile))
    return out


def suffix_refine_inputs(H, X, deg, lam1, lower, upper, power: int = 1,
                         deg_max: int = DEG_SUF):
    """The refine filters' inputs on the window X itself (no QR: the
    recurrence does not need an orthonormal V): V = X, θ the Rayleigh
    quotients of Hᵖ (p = ``power``, 2 for the H² filter), R = Hᵖ·V −
    V·diag(θ), and the tables from θ on (λ₁, lower, upper)."""
    from chase_tpu_torch.ops.filter import refine_tables
    Hw, V = H.astype(np.complex128), X.astype(np.complex128)
    HV = V
    for _ in range(power):
        HV = Hw @ HV
    theta = np.real(np.einsum("ij,ij->j", V.conj(), HV)) \
        / np.real(np.einsum("ij,ij->j", V.conj(), V))
    R = HV - V * theta
    if not np.issubdtype(H.dtype, np.complexfloating):
        R = R.real
    tabs = refine_tables(theta, deg, lam1, lower, upper, deg_max)
    return X, R.astype(H.dtype), tabs, (upper + lower) / 2.0


def _full_product(H):
    from chase_tpu_torch.ops import ring_hemm as rh
    if H.dtype in rh.KERNEL_DTYPES:
        return lambda v: rh.ring_hemm_reference(H, v)
    return lambda v: H @ v


def full_width_filter(H, X, degrees, lam1, lower, upper, deg_max,
                      products: int = 1):
    """The degree-masked Chebyshev recurrence as the ring filters ran it
    before the live suffix: every step's ``products`` products on the
    whole window, the retired columns masked after (plain torch)."""
    from chase_tpu_torch.types import filter_carry_dtype, numpy_scalar_type
    carry = filter_carry_dtype(H.dtype, X.dtype)
    rt = numpy_scalar_type(carry)
    lam1, lower, upper = rt(lam1), rt(lower), rt(upper)
    c = (upper + lower) / rt(2)
    e = (upper - lower) / rt(2)
    sigma1 = e / (lam1 - c)
    degs = torch.as_tensor(np.asarray(degrees))[None, :]
    prod = _full_product(H)

    def shift(v):
        w = v
        for _ in range(products):
            w = prod(w)
        return w - float(c) * v

    Xc = X.to(carry)
    Y = torch.where(degs >= 1, float(sigma1 / e) * shift(Xc), Xc)
    Xp, sigma = Xc, sigma1
    for t in range(2, int(deg_max) + 1):
        sigma_new = rt(1) / (rt(2) / sigma1 - sigma)
        Z = float(rt(2) * sigma_new / e) * shift(Y) \
            - float(sigma * sigma_new) * Xp
        Xp, Y = Y, torch.where(degs >= t, Z, Y)
        sigma = sigma_new
    return torch.where(degs >= 1, Y.to(X.dtype), X)


def full_width_refine(H, V, R, degrees, alpha1_e, alphas, betas, inj,
                      p_final, cc, deg_max, products: int = 1):
    """The deviation-form recurrence as the refine ring filters ran it
    before the live suffix (plain torch, whole window every step)."""
    from chase_tpu_torch.ops.filter import inj_table, refine_combine
    from chase_tpu_torch.types import filter_carry_dtype, numpy_scalar_type
    carry = filter_carry_dtype(H.dtype, V.dtype)
    rt = numpy_scalar_type(carry)
    ccf = float(rt(cc))
    degs = torch.as_tensor(np.asarray(degrees))[None, :]
    injt = inj_table(inj, carry, V.device)
    prod = _full_product(H)
    rc = R.to(carry)
    W = float(rt(alpha1_e)) * rc
    Wp = torch.zeros_like(W)
    for t in range(2, int(deg_max) + 1):
        w = W
        for _ in range(products):
            w = prod(w)
        Z = float(rt(alphas[t])) * (w - ccf * W) \
            + float(rt(betas[t])) * Wp + injt[t][None, :] * rc
        Wp, W = W, torch.where(degs >= t, Z, W)
    return refine_combine(V, W, p_final, degrees)


def eig_problem(name: str):
    """(H, nev, nex, tol) of a solve case; the name gives its matrix
    ("clement" or "random"), dtype, size ("_N130"; default 128) and, with
    "_ladder", the precision ladder's tolerance 1e-10."""
    from chase_tpu_torch.models import clement, random_hermitian
    parts = name.split("_")
    dtype = np.dtype(parts[1])
    N = next((int(q[1:]) for q in parts[2:] if q.startswith("N")), EIG["N"])
    H = (clement(N).astype(dtype) if parts[0] == "clement"
         else random_hermitian(N, dtype, seed=3))
    tol = 1e-10 if "ladder" in parts else TOL[dtype.name]
    return H, EIG["nev"], EIG["nex"], tol


def bse_problem(name: str):
    """(H, nev, nex, tol) of a BSE solve case: ``random_<dtype>`` with
    "_N130" for another size (default 128) and "_ladder" for the ladder's
    tolerance 1e-10."""
    from chase_tpu_torch.models import random_pseudo_hermitian
    parts = name.split("_")
    dtype = np.dtype(parts[1])
    N = next((int(q[1:]) for q in parts[2:] if q.startswith("N")), BSE["N"])
    tol = 1e-10 if "ladder" in parts else BSE_TOL[dtype.name]
    return (random_pseudo_hermitian(N, dtype, seed=5), BSE["nev"],
            BSE["nex"], tol)


def sops_inputs(dtype):
    """The S-ops' block (N_SOPS × K_SOPS) and K-conjugation's columns:
    mirrors of columns 1..4 written into columns 9..6."""
    rng = np.random.default_rng(51)
    X = rng.standard_normal((N_SOPS, K_SOPS))
    if np.issubdtype(dtype, np.complexfloating):
        X = X + 1j * rng.standard_normal((N_SOPS, K_SOPS))
    src = np.arange(K_SOPS)
    wmask = np.zeros(K_SOPS, bool)
    src[[9, 8, 7, 6]] = [1, 2, 3, 4]
    wmask[[9, 8, 7, 6]] = True
    return X.astype(dtype), src, wmask


def io_matrix(dtype):
    """The I/O cases' N×N Hermitian H (numpy, seeded)."""
    rng = np.random.default_rng(61)
    N = IO["N"]
    A = rng.standard_normal((N, N))
    if np.issubdtype(dtype, np.complexfloating):
        A = A + 1j * rng.standard_normal((N, N))
    return ((A + A.conj().T) / 2).astype(dtype)


def cli_matrix():
    """The CLI's --path_in file: a random Hermitian f64 H, N=128 (the
    JAX CLI splits it over its 8 devices)."""
    from chase_tpu_torch.models import random_hermitian
    return random_hermitian(128, np.float64, seed=64)


def io_rect():
    """The rectangular file's (N, M) f32 matrix."""
    return np.random.default_rng(62).standard_normal(
        (IO["N"], IO["M"])).astype(np.float32)


def io_state():
    """A checkpoint's (V (N × k) f64, ritzv (k,), meta)."""
    rng = np.random.default_rng(63)
    return (rng.standard_normal((IO["N"], IO["k"])),
            np.sort(rng.standard_normal(IO["k"])), {"tag": 7})


def iface_bse():
    """The interface cases' BSE H (c128, seeded)."""
    from chase_tpu_torch.models import random_pseudo_hermitian
    return np.asarray(random_pseudo_hermitian(IFACE_BSE["N"], np.complex128,
                                              seed=3))


# -- helpers ---------------------------------------------------------------

def full(grid, t: torch.Tensor) -> np.ndarray:
    """The whole multivector from this rank's rows."""
    return grid.all_gather(t.contiguous(), "r").numpy()


class _Counter:
    """Counts the ring's kernel steps: calls of ``ops.ring_hemm.ring_hemm``
    (looked up there by every ring product at call time), and records
    each one's width (V's columns)."""

    def __init__(self):
        from chase_tpu_torch.ops import ring_hemm as rh
        real, self.n, self.widths = rh.ring_hemm, 0, []

        def counting(H, V, **k):
            self.n += 1
            self.widths.append(V.shape[1])
            return real(H, V, **k)
        rh.ring_hemm = counting

    def take(self) -> int:
        n, self.n = self.n, 0
        self.widths = []
        return n

    def take_widths(self) -> list:
        widths = self.widths
        self.take()
        return widths


_COUNTER = []


def step_counter() -> _Counter:
    """The process's one step counter, reset."""
    if not _COUNTER:
        _COUNTER.append(_Counter())
    _COUNTER[0].take()
    return _COUNTER[0]


def expect_raise(exc, fn, *words) -> bool:
    """Whether ``fn()`` raises ``exc`` with every word in its message."""
    try:
        fn()
    except exc as e:
        return all(w in str(e) for w in words)
    return False


# -- cases -----------------------------------------------------------------

def case_mesh(grid, rec):
    import chase_tpu_torch as ct
    import torch.distributed as dist
    from chase_tpu_torch.parallel import multihost
    rec["mesh/shape"] = [grid.size("r"), grid.size("c")]
    rec["mesh/nprocs"] = grid.nprocs
    rec["mesh/coords"] = list(grid.coords)
    rec["mesh/rank"] = dist.get_rank()
    rec["mesh/group_r"] = dist.get_process_group_ranks(grid.group("r"))
    rec["mesh/group_c"] = dist.get_process_group_ranks(grid.group("c"))
    info = multihost.process_info()
    rec["mesh/info"] = [info["process_index"], info["process_count"],
                        info["local_devices"], info["global_devices"]]
    rec["mesh/multihost"] = multihost.is_multihost()
    multihost.ensure_initialized(device="cpu")            # a no-op now
    g = ct.make_grid(device="cpu")                        # near-square
    rec["mesh/default_shape"] = [g.size("r"), g.size("c")]
    n = grid.nprocs
    rec["mesh/bad_shape_raises"] = expect_raise(
        ValueError, lambda: ct.make_grid(shape=(n + 1, 1), device="cpu"),
        "does not cover")


def case_hemm(grid, rec):
    """The windowed filter's product on the grid against the dense one."""
    from chase_tpu_torch import DenseOperator
    from chase_tpu_torch.parallel import dist as pdist
    for dt in (np.float64, np.complex128):
        H, X, *_ = problem(96, 9, dt, 21)
        op = DenseOperator(H, grid=grid)
        W = pdist.hemm(op.H, op.place_block(X), grid)
        rec[f"hemm/{np.dtype(dt).name}"] = full(grid, W)


def case_ring(grid, rec):
    """ring_hemm(grid, H, V) in f32, c64 and f64, and its steps."""
    from chase_tpu_torch import DenseOperator
    from chase_tpu_torch.parallel import ring as pring
    count = step_counter()
    for dt in (np.float32, np.complex64, np.float64):
        H, X, *_ = problem(N_RING, K_RING, dt, 31)
        op = DenseOperator(H, grid=grid)
        W = pring.ring_hemm(grid, op.H, op.place_block(X))
        rec[f"ring/{np.dtype(dt).name}"] = full(grid, W)
        rec[f"ring/{np.dtype(dt).name}/steps"] = count.take()


def case_filters(grid, rec):
    """The p-step ring filters against the p = 1 filters on the whole
    operator; the ring's steps counted."""
    from chase_tpu_torch import DenseOperator
    from chase_tpu_torch.parallel import ring as pring
    count = step_counter()
    deg = filter_degrees()
    for name, dt, shadow, seed in FILTER_CASES:
        H, X, lam1, lo, up = problem(N_FILT, W_FILT, dt, seed)
        op = DenseOperator(H, grid=grid)
        Hg = op.H if shadow is None else op.H_low
        Hw = torch.from_numpy(H)
        if shadow is not None:
            Hw = Hw.to(getattr(torch, shadow))
        args = (deg, lam1, lo, up, DEG_FILT)
        Y = pring.chebyshev_filter_ring_pallas(Hg, op.place_block(X), *args,
                                               grid=grid)
        rec[f"filter/{name}/steps"] = count.take()
        rec[f"filter/{name}"] = full(grid, Y)
        rec[f"filter/{name}/p1"] = pring.chebyshev_filter_ring_pallas(
            Hw, torch.from_numpy(X), *args).numpy()
        count.take()
        V, R, tabs, cc = refine_inputs(H, X, deg)
        rargs = (deg, *tabs, cc, DEG_FILT)
        Y = pring.chebyshev_filter_refine_ring(
            Hg, op.place_block(V), op.place_block(R), *rargs, grid=grid)
        rec[f"refine/{name}/steps"] = count.take()
        rec[f"refine/{name}"] = full(grid, Y)
        rec[f"refine/{name}/p1"] = pring.chebyshev_filter_refine_ring(
            Hw, torch.from_numpy(V), torch.from_numpy(R), *rargs).numpy()
        count.take()


def case_tsqr(grid, rec):
    """tsqr of a tall block (N/p ≥ k) and of a wide one (the gathered
    dense QR)."""
    from chase_tpu_torch.ops.qr import tsqr
    rng = np.random.default_rng(41)
    for name, k in (("tall", 10), ("wide", 30)):
        V = rng.standard_normal((96, k))
        rows = grid.block(96, "r")
        Q = tsqr(torch.from_numpy(V[rows[0]:rows[0] + rows[1]]).clone(),
                 grid=grid)
        rec[f"tsqr/{name}"] = full(grid, Q)


def solve_case(grid, rec, name: str, key=None, **cfg):
    """eigsh on the grid and with grid=None (same seed) on the same H:
    spectra, residuals, iterations, locked count, the gathered V, and the
    ring's steps beside the filter's HEMM steps (recorded under ``key``,
    default ``name``)."""
    import chase_tpu_torch as ct
    H, nev, nex, tol = eig_problem(name)
    name = key or name
    count = step_counter()
    res = ct.eigsh(H, nev, nex, tol=tol, grid=grid, collect_perf=True,
                   config=ct.ChaseConfig(**cfg))
    rec[f"{name}/steps"] = count.take()
    rec[f"{name}/hemm_steps"] = res.perf.filter_hemm_steps
    r0 = ct.eigsh(H, nev, nex, tol=tol, device="cpu",
                  config=ct.ChaseConfig(**cfg))
    count.take()
    for key in ("ritzv", "resid", "iterations", "locked", "converged",
                "ritzv_full"):
        rec[f"{name}/{key}"] = getattr(res, key)
    rec[f"{name}/V"] = res.V.full_tensor()[:, :nev].numpy()
    rec[f"{name}/local_rows"] = res.V.to_local().shape[0]
    rec[f"{name}/ritzv0"] = r0.ritzv
    rec[f"{name}/iterations0"] = r0.iterations
    return res


def case_solves(cases):
    def run(grid, rec):
        for name, cfg in cases:
            solve_case(grid, rec, name, **cfg)
    return run


def case_sequence(grid, rec):
    import chase_tpu_torch as ct
    from chase_tpu_torch.models import hermitian_sequence
    seq = hermitian_sequence(96, 3, np.complex128, seed=17, drift=0.004)
    got = list(ct.eigsh_sequence(iter(seq), 10, 8, tol=1e-9, grid=grid))
    ref = list(ct.eigsh_sequence(iter(seq), 10, 8, tol=1e-9,
                                 device="cpu"))
    rec["sequence/iterations"] = [r.iterations for r in got]
    rec["sequence/iterations0"] = [r.iterations for r in ref]
    rec["sequence/ritzv"] = np.stack([r.ritzv for r in got])
    rec["sequence/resid"] = np.stack([r.resid for r in got])


def case_bounds(grid, rec):
    import chase_tpu_torch as ct
    from chase_tpu_torch.models import clement
    H = clement(128)
    b = ct.estimate_spectral_bounds(H, nev=12, grid=grid)
    b0 = ct.estimate_spectral_bounds(H, nev=12, device="cpu")
    rec["bounds"] = [b["upperb"], b["lambda_min"], b["lowerb"]]
    rec["bounds0"] = [b0["upperb"], b0["lambda_min"], b0["lowerb"]]


def case_warmup(grid, rec):
    import chase_tpu_torch as ct
    from chase_tpu_torch.models import clement
    out = ct.warmup(clement(128).astype(np.float32), 12, 8, grid=grid,
                    config=ct.ChaseConfig(ring_backend="pallas"))
    rec["warmup/failed"] = out["failed"]


def _ring_filter_runs(rec, key, solve, H, **cfg):
    """``solve`` with ring_filter True, None and False on the grid (f32
    on "pallas"): Ritz values, convergence, the kernel's steps and the
    filter's HEMM steps of each."""
    import chase_tpu_torch as ct
    count = step_counter()
    for rf in (True, None, False):
        res = solve(H, 4, 4, tol=TOL["float32"], collect_perf=True,
                    config=ct.ChaseConfig(ring_filter=rf,
                                          ring_backend="pallas", **cfg))
        rec[f"{key}/{rf}/steps"] = count.take()
        rec[f"{key}/{rf}/hemm_steps"] = res.perf.filter_hemm_steps
        rec[f"{key}/{rf}/ritzv"] = res.ritzv
        rec[f"{key}/{rf}/converged"] = res.converged


def case_ring_filter_2d(grid, rec):
    """ring_filter=True on an r×c grid takes the 2-D ring, as None does;
    False the windowed filter (no kernel step)."""
    import functools
    import chase_tpu_torch as ct
    from chase_tpu_torch.models import clement
    _ring_filter_runs(rec, "ring2d", functools.partial(ct.eigsh, grid=grid),
                      clement(64).astype(np.float32))


def case_dtensor(grid, rec):
    """H as a DTensor (Shard(0), Shard(1)) solves as the whole H does; a
    warm start from the DTensor result keeps V where it lies."""
    import chase_tpu_torch as ct
    from torch.distributed.tensor import Shard, distribute_tensor
    H, nev, nex, tol = eig_problem("clement_float64")
    Hd = distribute_tensor(torch.from_numpy(H), grid.mesh,
                           (Shard(0), Shard(1)))
    res = ct.eigsh(Hd, nev, nex, tol=tol, grid=grid)
    ref = ct.eigsh(H, nev, nex, tol=tol, grid=grid)
    rec["dtensor/equal"] = bool(np.array_equal(res.ritzv, ref.ritzv))
    warm = ct.eigsh(H, nev, nex, tol=tol, grid=grid, v0=res.V,
                    ritzv0=res.ritzv_full, approx=True)
    rec["dtensor/warm_iterations"] = warm.iterations
    rec["dtensor/warm_ritzv"] = warm.ritzv


def case_dtensor_padded(grid, rec):
    """A DTensor H (Shard(0), Shard(1)) whose N = 130 the grid pads: each
    rank's block built from its own shard, with ``full_tensor`` barred,
    beside the block of the whole H; a solve from it beside the whole
    H's; another layout refused."""
    import chase_tpu_torch as ct
    from chase_tpu_torch.models import random_hermitian
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    def no_gather(self, *a, **k):
        raise AssertionError("DTensor H gathered whole")
    gather, DTensor.full_tensor = DTensor.full_tensor, no_gather
    try:
        for dt in (np.float32, np.complex128):
            H = random_hermitian(130, dt, seed=8)
            Hd = distribute_tensor(torch.from_numpy(H), grid.mesh,
                                   (Shard(0), Shard(1)))
            name = np.dtype(dt).name
            rec[f"dtpad/{name}"] = ct.DenseOperator(Hd, grid=grid).H.numpy()
            rec[f"dtpad/{name}/whole"] = ct.DenseOperator(H,
                                                          grid=grid).H.numpy()
        H, nev, nex, tol = eig_problem("clement_float64_N130")
        Hd = distribute_tensor(torch.from_numpy(H), grid.mesh,
                               (Shard(0), Shard(1)))
        rec["dtpad/ritzv"] = ct.eigsh(Hd, nev, nex, tol=tol, grid=grid).ritzv
        Ht = distribute_tensor(torch.from_numpy(H), grid.mesh,
                               (Shard(1), Shard(0)))
        rec["dtpad/other_layout_raises"] = expect_raise(
            ValueError, lambda: ct.DenseOperator(Ht, grid=grid),
            "must be sharded (Shard(0), Shard(1))")
    finally:
        DTensor.full_tensor = gather
    rec["dtpad/ritzv/whole"] = ct.eigsh(H, nev, nex, tol=tol,
                                        grid=grid).ritzv
    rec["dtpad/coords"] = list(grid.coords)


def case_fused_11(grid, rec):
    """The one-device solvers take a 1×1 grid."""
    import chase_tpu_torch as ct
    from chase_tpu_torch.models import clement
    H = clement(128)
    r = ct.eigsh_fused(H, 12, 8, tol=1e-9, grid=grid)
    r0 = ct.eigsh_fused(H, 12, 8, tol=1e-9, device="cpu")
    rec["fused11/ritzv"] = r.ritzv
    rec["fused11/ritzv0"] = r0.ritzv


def pseudo_case(grid, rec, name: str, warm: bool = False, key=None,
                **cfg):
    """eigsh_pseudo on the grid and with grid=None (same seed) on the same
    H, recorded as :func:`solve_case` records eigsh; with ``warm`` a warm
    start from the grid result's DTensor V too."""
    import chase_tpu_torch as ct
    H, nev, nex, tol = bse_problem(name)
    name = key or name
    count = step_counter()
    res = ct.eigsh_pseudo(H, nev, nex, tol=tol, grid=grid, collect_perf=True,
                          config=ct.ChaseConfig(**cfg))
    rec[f"{name}/steps"] = count.take()
    rec[f"{name}/hemm_steps"] = res.perf.filter_hemm_steps
    r0 = ct.eigsh_pseudo(H, nev, nex, tol=tol, device="cpu",
                         config=ct.ChaseConfig(**cfg))
    count.take()
    for key in ("ritzv", "resid", "iterations", "locked", "converged",
                "ritzv_full"):
        rec[f"{name}/{key}"] = getattr(res, key)
    rec[f"{name}/V"] = res.V.full_tensor()[:, :nev].numpy()
    rec[f"{name}/local_rows"] = res.V.to_local().shape[0]
    rec[f"{name}/ritzv0"] = r0.ritzv
    rec[f"{name}/iterations0"] = r0.iterations
    if warm:
        w = ct.eigsh_pseudo(H, nev, nex, tol=tol, grid=grid, v0=res.V,
                            approx=True, config=ct.ChaseConfig(**cfg))
        rec[f"{name}/warm_iterations"] = w.iterations
        rec[f"{name}/warm_ritzv"] = w.ritzv


def case_pseudo(cases):
    def run(grid, rec):
        for name, cfg in cases:
            pseudo_case(grid, rec, name, **cfg)
    return run


def case_sops(grid, rec):
    """apply_s, flip_locked_cols and k_conjugate_cols on this rank's rows
    of an N_SOPS-row block (f64 and c128)."""
    from chase_tpu_torch.ops import pseudo as ps
    r0, n = grid.block(N_SOPS, "r")
    for dt in (np.float64, np.complex128):
        X, src, wmask = sops_inputs(dt)
        Xl = torch.from_numpy(X[r0:r0 + n]).clone()
        name = np.dtype(dt).name
        rec[f"sops/{name}/apply_s"] = ps.apply_s(Xl, r0, N_SOPS).numpy()
        rec[f"sops/{name}/flip"] = ps.flip_locked_cols(Xl, 4, r0,
                                                       N_SOPS).numpy()
        grid.stats.reset()
        rec[f"sops/{name}/kconj"] = ps.k_conjugate_cols(Xl, src, wmask,
                                                        grid).numpy()
        rec[f"sops/{name}/rotate"] = list(grid.stats.summary().get(
            "rotate", (0, 0)))
    rec["sops/rows"] = [r0, n]


def case_bse_pad(grid, rec):
    """The S-preserving pad: each rank's block of a pseudo-Hermitian
    operator of N = 130 (the halves pad to a multiple of r·c), its
    (N/2, h_pad) and the unpadded rows of a block placed on it."""
    import chase_tpu_torch as ct
    from chase_tpu_torch.models import random_pseudo_hermitian
    for dt in (np.float64, np.complex128):
        H = random_pseudo_hermitian(130, dt, seed=8)
        op = ct.DenseOperator(H, grid=grid, pseudo_hermitian=True)
        name = np.dtype(dt).name
        rec[f"bsepad/{name}"] = op.H.numpy()
        rec[f"bsepad/{name}/H"] = H        # this process's bits of it
        rec["bsepad/half"] = list(op.half)
        V = np.arange(130 * 3, dtype=np.float64).reshape(130, 3)
        rec[f"bsepad/{name}/placed"] = full(grid, op.place_block(V))
        rec[f"bsepad/{name}/unpad"] = op.unpad_block(
            op.place_block(V)).numpy()
    rec["bsepad/coords"] = list(grid.coords)


def case_bse_dtensor(grid, rec):
    """A pseudo-Hermitian DTensor H (Shard(0), Shard(1)) of N = 130 whose
    halves the grid pads: each rank's block built from its own shard with
    ``full_tensor`` barred, beside the block of the whole H, and a solve
    from it beside the whole H's."""
    import chase_tpu_torch as ct
    from chase_tpu_torch.models import random_pseudo_hermitian
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    def no_gather(self, *a, **k):
        raise AssertionError("DTensor H gathered whole")
    H, nev, nex, tol = bse_problem("random_float64_N130")
    Hd = distribute_tensor(torch.from_numpy(H), grid.mesh,
                           (Shard(0), Shard(1)))
    gather, DTensor.full_tensor = DTensor.full_tensor, no_gather
    try:
        for dt in (np.float32, np.complex128):
            Hx = random_pseudo_hermitian(130, dt, seed=8)
            Hxd = distribute_tensor(torch.from_numpy(Hx), grid.mesh,
                                    (Shard(0), Shard(1)))
            name = np.dtype(dt).name
            rec[f"bsedt/{name}"] = ct.DenseOperator(
                Hxd, grid=grid, pseudo_hermitian=True).H.numpy()
            rec[f"bsedt/{name}/whole"] = ct.DenseOperator(
                Hx, grid=grid, pseudo_hermitian=True).H.numpy()
        op = ct.DenseOperator(Hd, grid=grid, pseudo_hermitian=True)
    finally:
        DTensor.full_tensor = gather
    rec["bsedt/ritzv"] = ct.eigsh_pseudo(op, nev, nex, tol=tol).ritzv
    rec["bsedt/ritzv/whole"] = ct.eigsh_pseudo(H, nev, nex, tol=tol,
                                               grid=grid).ritzv
    rec["bsedt/coords"] = list(grid.coords)


def fused_cases(grid, rec, name: str, **cfg):
    """eigsh_fused (Clement) and eigsh_pseudo_fused (a random BSE) of
    ``name``'s dtype on the grid and with grid=None, recorded as
    :func:`solve_case` records eigsh, and the ring's steps."""
    import chase_tpu_torch as ct
    from chase_tpu_torch.models import clement, random_pseudo_hermitian
    dtype = np.dtype(name)
    tol = BSE_TOL[dtype.name]
    count = step_counter()
    for what, solve, H in (
            ("fused", ct.eigsh_fused, clement(BSE["N"]).astype(dtype)),
            ("pfused", ct.eigsh_pseudo_fused,
             random_pseudo_hermitian(BSE["N"], dtype, seed=5))):
        key = f"{what}/{name}"
        res = solve(H, BSE["nev"], BSE["nex"], tol=tol, grid=grid,
                    collect_perf=True, config=ct.ChaseConfig(**cfg))
        rec[f"{key}/steps"] = count.take()
        rec[f"{key}/hemm_steps"] = res.perf.filter_hemm_steps
        r0 = solve(H, BSE["nev"], BSE["nex"], tol=tol, device="cpu",
                   config=ct.ChaseConfig(**cfg))
        count.take()
        for k in ("ritzv", "resid", "iterations", "locked", "converged"):
            rec[f"{key}/{k}"] = getattr(res, k)
        rec[f"{key}/V"] = res.V.full_tensor()[:, :BSE["nev"]].numpy()
        rec[f"{key}/iterations0"] = r0.iterations


def case_fused(cases):
    def run(grid, rec):
        for name, cfg in cases:
            fused_cases(grid, rec, name, **cfg)
    return run


def case_fused_warmup(grid, rec):
    """warmup(fused=True) on the grid, Hermitian and BSE."""
    import chase_tpu_torch as ct
    from chase_tpu_torch.models import clement, random_pseudo_hermitian
    out = ct.warmup(clement(64), 6, 4, grid=grid, fused=True)
    op = ct.DenseOperator(random_pseudo_hermitian(64, np.float64, seed=5),
                          grid=grid, pseudo_hermitian=True)
    outp = ct.warmup(op, 6, 4, grid=grid, fused=True)
    rec["fwarmup"] = [out["programs"], out["failed"], outp["programs"],
                      outp["failed"]]


def case_pseudo_ring_filter_2d(grid, rec):
    """ring_filter=True on an r×c grid takes the 2-D H² ring for
    eigsh_pseudo too, as None does; False the windowed H² filter."""
    import functools
    import chase_tpu_torch as ct
    H, *_ = bse_problem("random_float32")
    _ring_filter_runs(rec, "pring2d",
                      functools.partial(ct.eigsh_pseudo, grid=grid), H)


# -- the 2-D rings ---------------------------------------------------------

def _low(op, shadow):
    return op.H if shadow is None else op.H_low


def _whole_op(H, shadow):
    Hw = torch.from_numpy(H)
    return Hw if shadow is None else Hw.to(getattr(torch, shadow))


def case_passes2d(grid, rec):
    """ring_A and ring_B of a general (non-Hermitian) H on this rank's
    parity chunks, on the kernel's step where the operator takes it
    (ring_B on its trans route) and on torch.matmul otherwise; the steps of
    each pass."""
    from chase_tpu_torch import DenseOperator
    from chase_tpu_torch.ops.ring_hemm import KERNEL_DTYPES
    from chase_tpu_torch.parallel.ring import Ring2D
    count = step_counter()
    rng = np.random.default_rng(61)
    N, k = N_FILT, K_RING
    nch = N // grid.nprocs
    for name, dt, shadow, _ in FILTER_CASES_2D:
        A = rng.standard_normal((N, N))
        X = rng.standard_normal((N, k))
        if np.issubdtype(dt, np.complexfloating):
            A = A + 1j * rng.standard_normal((N, N))
            X = X + 1j * rng.standard_normal((N, k))
        op = DenseOperator(A.astype(dt), grid=grid)
        Hf = _low(op, shadow)
        # the chunks in the carry: f32 beside an f32 or bf16 shadow
        X = X.astype(dt if shadow is None else np.float32)
        ring = Ring2D(grid, Hf, Hf.dtype in KERNEL_DTYPES)
        xa = X[grid.parity_chunk("A") * nch:][:nch]
        xb = X[grid.parity_chunk("B") * nch:][:nch]
        count.take()
        rec[f"passA/{name}"] = ring.ring_A(torch.from_numpy(xa)).numpy()
        rec[f"passA/{name}/steps"] = count.take()
        rec[f"passB/{name}"] = ring.ring_B(torch.from_numpy(xb)).numpy()
        rec[f"passB/{name}/steps"] = count.take()
        rec[f"pass/{name}/H"] = _whole_op(A.astype(dt), shadow).to(
            torch.complex128).numpy()
        rec[f"pass/{name}/X"] = X
    rec["pass/chunks"] = [grid.parity_chunk("A"), grid.parity_chunk("B")]


def _filter2d_runs(grid, rec, key, fn, ref, op_args, rows, tail, kernel):
    """``fn`` on the grid (the whole result gathered) and ``ref`` (the
    port's p = 1 filter) on the whole inputs, with the kernel's steps."""
    count = step_counter()
    Y = fn(grid, *op_args, *tail, kernel=kernel)
    rec[f"{key}/steps"] = count.take()
    rec[key] = full(grid, Y)
    rec[f"{key}/p1"] = ref(*rows, *tail).numpy()
    count.take()


def case_filters2d(grid, rec):
    """The four 2-D ring filters on each case of FILTER_CASES_2D with an
    even and an odd deg_max, against the port's p = 1 filters on the
    whole operator; the kernel's steps where the operator takes it."""
    import functools
    from chase_tpu_torch import DenseOperator
    from chase_tpu_torch.ops.ring_hemm import KERNEL_DTYPES
    from chase_tpu_torch.parallel import ring as pring
    for name, dt, shadow, seed in FILTER_CASES_2D:
        kernel = (shadow is not None
                  or np.dtype(dt) in (np.float32, np.complex64))
        for dm in DEGS_2D:
            deg = filter_degrees(deg_max=dm)
            # Hermitian and refine
            H, X, lam1, lo, up = problem(N_FILT, W_FILT, dt, seed)
            op = DenseOperator(H, grid=grid)
            Hg, Hw = _low(op, shadow), _whole_op(H, shadow)
            assert (Hg.dtype in KERNEL_DTYPES) == kernel
            p1 = (pring.chebyshev_filter_ring_pallas if kernel
                  else functools.partial(pring.chebyshev_filter_ring, None))
            _filter2d_runs(grid, rec, f"f2d/{name}/{dm}",
                           pring.chebyshev_filter_ring2d, p1,
                           (Hg, op.place_block(X)),
                           (Hw, torch.from_numpy(X)),
                           (deg, lam1, lo, up, dm), kernel)
            V, R, tabs, cc = refine_inputs(H, X, deg, dm)
            _filter2d_runs(grid, rec, f"r2d/{name}/{dm}",
                           pring.chebyshev_filter_refine_ring2d,
                           functools.partial(
                               pring.chebyshev_filter_refine_ring,
                               kernel=kernel),
                           (Hg, op.place_block(V), op.place_block(R)),
                           (Hw, torch.from_numpy(V), torch.from_numpy(R)),
                           (deg, *tabs, cc, dm), kernel)
            # H² and refine H² on a BSE operator
            H, X, lam1, lo, up = bse_filter_problem(N_FILT, W_FILT, dt,
                                                    seed)
            op = DenseOperator(H, grid=grid, pseudo_hermitian=True)
            Hg, Hw = _low(op, shadow), _whole_op(H, shadow)
            _filter2d_runs(grid, rec, f"h2d/{name}/{dm}",
                           pring.chebyshev_filter_h2_ring2d,
                           functools.partial(pring.chebyshev_filter_h2_ring,
                                             kernel=kernel),
                           (Hg, op.place_block(X)),
                           (Hw, torch.from_numpy(X)),
                           (deg, lam1, lo, up, dm), kernel)
            V, R2, tabs, cc = refine_h2_inputs(H, X, deg, lam1, lo, up, dm)
            _filter2d_runs(grid, rec, f"rh2d/{name}/{dm}",
                           pring.chebyshev_filter_refine_h2_ring2d,
                           functools.partial(
                               pring.chebyshev_filter_refine_h2_ring,
                               kernel=kernel),
                           (Hg, op.place_block(V), op.place_block(R2)),
                           (Hw, torch.from_numpy(V), torch.from_numpy(R2)),
                           (deg, *tabs, cc, dm), kernel)


# (name, window dtype, shadow dtype or None, problem seed): the f64
# window on torch.matmul (W tile 1), c64 and a c128 window on its c64
# shadow (the grid cell's route) on the kernel (W tile 64)
SUFFIX_CASES_2D = (("f64", np.float64, None, 71),
                   ("c64", np.complex64, None, 72),
                   ("c128_on_c64", np.complex128, "complex64", 73))
SUFFIX_DEGREES = ("sorted", "unsorted", "equal")


def case_suffix2d(grid, rec):
    """The 2-D Hermitian and refine ring filters on windows wider than a
    W tile, with a pad of degree 0 and sorted, unsorted and equal
    degrees: the gathered result and every kernel step's width."""
    from chase_tpu_torch import DenseOperator
    from chase_tpu_torch.ops.ring_hemm import KERNEL_DTYPES
    from chase_tpu_torch.parallel import ring as pring
    count = step_counter()
    for name, dt, shadow, seed in SUFFIX_CASES_2D:
        H, X, lam1, lo, up = problem(N_SUF, W_SUF, dt, seed)
        op = DenseOperator(H, grid=grid)
        Hg = _low(op, shadow)
        kernel = Hg.dtype in KERNEL_DTYPES
        for kind in SUFFIX_DEGREES:
            deg = suffix_degrees(kind)
            key = f"suf2d/{name}/{kind}"
            Y = pring.chebyshev_filter_ring2d(
                grid, Hg, op.place_block(X), deg, lam1, lo, up, DEG_SUF,
                kernel=kernel)
            rec[f"{key}/f/widths"] = count.take_widths()
            rec[f"{key}/f"] = full(grid, Y)
            V, R, tabs, cc = suffix_refine_inputs(H, X, deg, lam1, lo, up)
            Y = pring.chebyshev_filter_refine_ring2d(
                grid, Hg, op.place_block(V), op.place_block(R), deg, *tabs,
                cc, DEG_SUF, kernel=kernel)
            rec[f"{key}/r/widths"] = count.take_widths()
            rec[f"{key}/r"] = full(grid, Y)


def case_grid_no_copy(grid, rec):
    """Ring2D on the kernel's steps over this rank's c64 shadow of a c128
    block: which operator each ring_hemm call of ring_A and ring_B reads
    (the shadow itself, ring_B's with trans=True), and the tensors the
    operator and the ring hold afterwards."""
    import torch
    from chase_tpu_torch import DenseOperator
    from chase_tpu_torch.ops import ring_hemm as rh
    from chase_tpu_torch.parallel.ring import Ring2D
    H, X, *_ = problem(N_FILT, W_FILT, np.complex64, 12)
    op = DenseOperator(H.astype(np.complex128), grid=grid)
    low = op.H_low
    ring = Ring2D(grid, low, True)
    nch = N_FILT // grid.nprocs
    reads, real = [], rh.ring_hemm

    def spy(Hs, V, **kw):
        reads.append([Hs is low, bool(kw.get("trans"))])
        return real(Hs, V, **kw)
    rh.ring_hemm = spy
    try:
        X = torch.from_numpy(X.astype(np.complex64))
        ring.ring_A(X[grid.parity_chunk("A") * nch:][:nch])
        ring.ring_B(X[grid.parity_chunk("B") * nch:][:nch])
    finally:
        rh.ring_hemm = real
    rec["nocopy/reads"] = reads
    rec["nocopy/op_tensors"] = sorted(
        k for k, v in vars(op).items() if isinstance(v, torch.Tensor))
    rec["nocopy/ring_tensors"] = sorted(
        k for k, v in vars(ring).items() if isinstance(v, torch.Tensor))
    rec["nocopy/ring_H_is_shadow"] = ring.H is low


# the solves whose operator takes a DTensor H's block in place: Clement
# c128 natively and the f64 ladder on the kernel's route
INPLACE_SOLVES = (("clement_complex128", {}),
                  ("clement_float64_ladder", {"ring_backend": "pallas",
                                              "mixed_precision": True}))


def _dtensor(grid, H):
    """H (numpy, whole) as a DTensor (Shard(0), Shard(1)) on the grid."""
    from torch.distributed.tensor import Shard, distribute_tensor
    return distribute_tensor(torch.from_numpy(H), grid.mesh,
                             (Shard(0), Shard(1)))


def _comm_counts() -> dict:
    from chase_tpu_torch import perf
    return {k: n for k, n in perf.COUNTS.items()
            if k.startswith((perf.COMM, perf.COMM_BYTES))}


def case_inplace(grid, rec):
    """A DTensor H that the grid does not pad: the operator's block is the
    DTensor's local tensor (its storage); with the layout check forced
    off, a copy (what every such H took before); a lazily conjugated one,
    a copy.  Each case of INPLACE_SOLVES solved from the block in place
    and from the copy."""
    import chase_tpu_torch as ct
    from chase_tpu_torch.parallel import operator as pop
    for name, cfg in INPLACE_SOLVES:
        H, nev, nex, tol = eig_problem(name)
        Hd = _dtensor(grid, H)
        ptr = Hd.to_local().data_ptr()
        config = ct.ChaseConfig(**cfg)
        rec[f"inplace/{name}/shares"] = \
            ct.DenseOperator(Hd, grid=grid).H.data_ptr() == ptr
        runs = {"in_place": ct.eigsh(Hd, nev, nex, tol=tol, grid=grid,
                                     config=config)}
        keep = pop._has_operator_layout
        pop._has_operator_layout = lambda t: False
        try:
            rec[f"inplace/{name}/copy_shares"] = \
                ct.DenseOperator(Hd, grid=grid).H.data_ptr() == ptr
            runs["copy"] = ct.eigsh(Hd, nev, nex, tol=tol, grid=grid,
                                    config=config)
        finally:
            pop._has_operator_layout = keep
        for how, res in runs.items():
            for key in ("ritzv", "resid", "iterations", "ritzv_full"):
                rec[f"inplace/{name}/{how}/{key}"] = getattr(res, key)
            rec[f"inplace/{name}/{how}/V"] = res.V.to_local().numpy()
    Hc = _dtensor(grid, eig_problem("clement_complex128")[0]).conj()
    op = ct.DenseOperator(Hc, grid=grid)
    rec["inplace/conj_shares"] = \
        op.H.data_ptr() == Hc.to_local().data_ptr()
    rec["inplace/conj_block"] = op.H.numpy()
    rec["inplace/conj_block_want"] = Hc.to_local().resolve_conj().numpy()


def case_comm(grid, rec):
    """A (2, 2) solve's collectives: the increase of the program's
    "comm:<kind>" / "comm_bytes:<kind>" counts beside the grid's own
    stats; the span ``chase.comm`` opened as a profiler range in no
    solve without a profiler (phase clock off and on), and in a traced
    one as often as the trace holds it."""
    import chase_tpu_torch as ct
    from torch.profiler import ProfilerActivity, profile
    H, nev, nex, tol = eig_problem("clement_complex128")
    Hd = _dtensor(grid, H)
    before = _comm_counts()
    grid.stats.reset()
    ct.eigsh(Hd, nev, nex, tol=tol, grid=grid)
    after = _comm_counts()
    stats = grid.stats.summary()
    grown = sorted({k.split(":", 1)[1] for k, n in after.items()
                    if n != before.get(k, 0)})
    rec["comm/kinds"] = sorted(stats)
    rec["comm/grown"] = grown
    rec["comm/stats"] = [list(stats[k]) for k in sorted(stats)]
    rec["comm/counts"] = [
        [after.get(f"comm:{k}", 0) - before.get(f"comm:{k}", 0),
         after.get(f"comm_bytes:{k}", 0) - before.get(f"comm_bytes:{k}", 0)]
        for k in sorted(stats)]
    opened, real = [], torch.profiler.record_function

    def spy(name, *a, **kw):
        opened.append(name)
        return real(name, *a, **kw)
    torch.profiler.record_function = spy
    try:
        for perf_on in (False, True):
            ct.eigsh(Hd, nev, nex, tol=tol, grid=grid, collect_perf=perf_on)
            rec[f"spans/untraced/{perf_on}"] = len(opened)
            opened.clear()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            ct.eigsh(Hd, nev, nex, tol=tol, grid=grid)
    finally:
        torch.profiler.record_function = real
    rec["spans/opened"] = opened.count("chase.comm")
    rec["spans/traced"] = sum(e.name == "chase.comm" for e in prof.events())


def case_ring_filter_values(case_fn, cases):
    """Each case with ring_filter None and True (keys ``<case>/<value>``)."""
    def run(grid, rec):
        for name, cfg in cases:
            for rf in (None, True):
                case_fn(grid, rec, name, key=f"{name}/{rf}",
                        ring_filter=rf, **cfg)
    return run


def case_fused2d(grid, rec):
    """eigsh_fused in f32 with ring_backend="pallas" on an r×c grid: no
    kernel step (the fused solvers take dist.hemm there), its
    collectives counted."""
    import chase_tpu_torch as ct
    from chase_tpu_torch.models import clement
    count = step_counter()
    grid.stats.reset()
    res = ct.eigsh_fused(clement(BSE["N"]).astype(np.float32), BSE["nev"],
                         BSE["nex"], tol=BSE_TOL["float32"], grid=grid,
                         collect_perf=True,
                         config=ct.ChaseConfig(ring_backend="pallas"))
    rec["fused2d/steps"] = count.take()
    rec["fused2d/hemm_steps"] = res.perf.filter_hemm_steps
    rec["fused2d/converged"] = res.converged
    rec["fused2d/ritzv"] = res.ritzv
    rec["fused2d/kinds"] = sorted(grid.stats.calls)
    rec["fused2d/all_gather"] = grid.stats.calls["all_gather"]


def case_io(grid, rec):
    """The sharded and block-cyclic readers on the files the test wrote
    with the JAX package (jax_<dtype>.bin, jax_rect.bin); the sharded
    writer into port_*.bin from the readers' DTensors and from the whole
    V in each sharding; a sharded writer over an oversized file; the
    refused layouts; layouts on a DTensor."""
    from torch.distributed.tensor import (DTensor, Partial, Shard,
                                          distribute_tensor)
    from chase_tpu_torch import io as tio
    from chase_tpu_torch.parallel import (colvec_sharding, matrix_sharding,
                                          replicated_sharding,
                                          rowvec_sharding)
    from chase_tpu_torch.parallel.layouts import BlockCyclicLayout
    N, M, mb = IO["N"], IO["M"], IO["mb"]
    rec["io/coords"] = list(grid.coords)
    loaded = {}
    for dt in IO_DTYPES:
        name = np.dtype(dt).name
        path = os.path.join(DIR, f"jax_{name}.bin")
        Hd = loaded[name] = tio.load_matrix_sharded(path, N, dt, grid)
        rec[f"io/{name}"] = Hd.to_local().numpy()
        rec[f"io/{name}/layout"] = (Hd.placements == matrix_sharding(
            grid).placements and Hd.device_mesh is grid.mesh
            and tuple(Hd.shape) == (N, N))
        tio.save_matrix_sharded(Hd, os.path.join(DIR, f"port_{name}.bin"))
        Hb, lay = tio.load_matrix_blockcyclic(path, N, dt, grid, mb)
        rec[f"bc/{name}"] = Hb.to_local().numpy()
        rec[f"bc/{name}/perm"] = lay.row_perm
    R = tio.load_matrix_sharded(os.path.join(DIR, "jax_rect.bin"), N,
                                np.float32, grid, M=M)
    rec["io/rect"] = R.to_local().numpy()
    tio.save_matrix_sharded(R, os.path.join(DIR, "port_rect.bin"))
    V = torch.from_numpy(io_state()[0])
    for name, sh in (("colvec", colvec_sharding(grid)),
                     ("rowvec", rowvec_sharding(grid)),
                     ("replicated", replicated_sharding(grid))):
        tio.save_matrix_sharded(distribute_tensor(V, *sh),
                                os.path.join(DIR, f"port_{name}.bin"))
    tio.save_matrix_sharded(loaded["float64"],
                            os.path.join(DIR, "oversized.bin"))
    tio.save_matrix_sharded(V.numpy(), os.path.join(DIR, "port_plain.bin"))
    bad = os.path.join(DIR, "refused.bin")
    rec["io/refused"] = [
        expect_raise(ValueError, lambda: tio.save_matrix_sharded(
            DTensor.from_local(V, grid.mesh, pl, run_check=False), bad),
            "placements") for pl in ((Shard(0), Shard(0)),
                                     (Partial(), Shard(1)))]
    rec["io/refused_wrote"] = os.path.exists(bad)
    rec["io/short_raises"] = expect_raise(
        ValueError, lambda: tio.load_matrix_sharded(
            os.path.join(DIR, "jax_rect.bin"), N, np.float32, grid),
        "bytes < expected")
    lay = BlockCyclicLayout(N, mb, grid.size("r"), grid.size("c"))
    Vd = distribute_tensor(V, *colvec_sharding(grid))
    rec["layout/dtensor"] = lay.apply_rows(Vd).numpy()
    rec["layout/dtensor_restore"] = lay.restore_rows(Vd).numpy()


def case_state(grid, rec):
    """Sharded checkpoints: the port's (read back by the test with the
    JAX package) and the JAX package's (jax_state, read here with and
    without the grid); a solve's V through a sharded checkpoint and a
    warm start from it."""
    import chase_tpu_torch as ct
    from torch.distributed.tensor import distribute_tensor
    from chase_tpu_torch import io as tio
    from chase_tpu_torch.models import clement
    from chase_tpu_torch.parallel import colvec_sharding
    V, ritzv, meta = io_state()
    Vd = distribute_tensor(torch.from_numpy(V), *colvec_sharding(grid))
    tio.save_state(os.path.join(DIR, "port_state"), Vd, ritzv, meta,
                   sharded=True)
    V2, r2, m2 = tio.load_state(os.path.join(DIR, "port_state.npz"),
                                grid=grid)
    rec["state/port"] = V2.to_local().numpy()
    rec["state/port/same"] = (bool(torch.equal(V2.to_local(),
                                               Vd.to_local()))
                              and np.array_equal(r2, ritzv) and m2 == meta
                              and V2.placements == Vd.placements)
    V3, r3, m3 = tio.load_state(os.path.join(DIR, "jax_state"), grid=grid)
    rec["state/jax"] = V3.to_local().numpy()
    rec["state/jax/ritzv"] = r3
    rec["state/jax/meta"] = m3 == meta
    rec["state/jax/layout"] = V3.placements == Vd.placements
    rec["state/jax/whole"] = tio.load_state(os.path.join(DIR,
                                                         "jax_state"))[0]
    H = clement(IO["N"])
    res = ct.eigsh(H, 8, 8, tol=1e-9, grid=grid)
    tio.save_state(os.path.join(DIR, "solve_state"), res.V,
                   res.ritzv_full, sharded=True)
    V4, r4, _ = tio.load_state(os.path.join(DIR, "solve_state"), grid=grid)
    rec["state/solve/bitwise"] = (bool(torch.equal(V4.to_local(),
                                                   res.V.to_local()))
                                  and np.array_equal(r4, res.ritzv_full))
    warm = ct.eigsh(H, 8, 8, tol=1e-9, grid=grid, v0=V4, ritzv0=r4,
                    approx=True)
    rec["state/solve/iterations"] = [res.iterations, warm.iterations]
    rec["state/solve/ritzv"] = warm.ritzv


CLI_GRID = {
    "grid": lambda d: ["--n", "128", "--nev", "8", "--nex", "8",
                       "--isMatGen", "clement", "--tol", "1e-9", "--grid"],
    "mb": lambda d: ["--n", "128", "--nev", "6", "--nex", "6",
                     "--tol", "1e-9", "--grid", "--mb", str(IO["mb"]),
                     "--path_in", os.path.join(d, "jax_cli.bin"),
                     "--dtype", "float64"],
}


def case_cli(grid, rec):
    """``cli.main`` with --grid and with --grid --mb on every rank (its
    group already made): exit codes and what each rank printed."""
    import contextlib
    import io
    from chase_tpu_torch import cli
    for name, argv in CLI_GRID.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rec[f"cli/{name}/rc"] = cli.main(argv(DIR) + ["--device", "cpu"])
        rec[f"cli/{name}/out"] = buf.getvalue()


def _iface_solve(iface, rec, key, warm=True):
    """solve on the bound session, get_eigenpairs, a mode-'A' solve."""
    rec[f"{key}/rc"] = iface.solve()
    evals, evecs = iface.get_eigenpairs()
    rec[f"{key}/ritzv"] = evals
    rec[f"{key}/V"] = evecs
    rec[f"{key}/iterations"] = iface._require().result.iterations
    if warm:
        iface.solve(mode="A")
        rec[f"{key}/warm"] = iface._require().result.iterations


def case_iface(grid, rec):
    """The interface's distributed modes on the group's grid shape:
    whole (row- and column-major), pseudo, block-cyclic Hermitian and
    pseudo, per rank Hermitian and pseudo (and a per-rank mode-'A' solve
    from the init buffers); the refusals; has_distribution."""
    import chase_tpu_torch.interface as tf
    from chase_tpu_torch.models import clement
    import torch.distributed as dist
    shape = (grid.size("r"), grid.size("c"))
    d0, d1 = shape
    N, nev, nex, tol, mb = (IFACE[k] for k in ("N", "nev", "nex", "tol",
                                                "mb"))
    H = clement(N)
    Nb, bnev, bnex, btol = (IFACE_BSE[k] for k in ("N", "nev", "nex",
                                                   "tol"))
    B = iface_bse()
    rec["iface/rank"] = dist.get_rank()
    rec["iface/has_distribution"] = tf.has_distribution()
    for major in ("R", "C"):
        tf.init(N, nev, nex, H, distributed=True, grid_shape=shape,
                grid_major=major, device="cpu")
        tf.set_tol(tol)
        rec[f"iface/whole{major}/coords"] = list(tf._require().grid.coords)
        _iface_solve(tf, rec, f"iface/whole{major}")
    tf.init_pseudo(Nb, bnev, bnex, B, distributed=True, grid_shape=shape,
                   device="cpu")
    tf.set_tol(btol)
    _iface_solve(tf, rec, "iface/pseudo")
    tf.init_blockcyclic(N, nev, nex, mb, mb, H, grid_shape=shape,
                        device="cpu")
    tf.set_tol(tol)
    rec["iface/bc/identity"] = bool(np.array_equal(
        tf._require().layout.row_perm, np.arange(N)))
    _iface_solve(tf, rec, "iface/bc")
    tf.init_blockcyclic(Nb, bnev, bnex, mb, mb, B, pseudo=True,
                        grid_shape=shape, device="cpu")
    tf.set_tol(btol)
    _iface_solve(tf, rec, "iface/bc_pseudo", warm=False)
    if N % (d0 * d1) == 0:
        i, j = grid.coords
        m, n = N // d0, N // d1
        tf.init_dist_local(N, nev, nex, m, n,
                           H[i * m:(i + 1) * m, j * n:(j + 1) * n],
                           grid_shape=shape, device="cpu")
        tf.set_tol(tol)
        _iface_solve(tf, rec, "iface/local", warm=False)
        res = tf._require().result
        Vl, r = res.V.to_local().numpy(), res.ritzv_full
        tf.init_dist_local(N, nev, nex, m, n,
                           H[i * m:(i + 1) * m, j * n:(j + 1) * n], Vl, r,
                           grid_shape=shape, device="cpu")
        tf.set_tol(tol)
        tf.solve(mode="A")
        rec["iface/local/warm_from_buffers"] = \
            tf._require().result.iterations
        m, n = Nb // d0, Nb // d1
        tf.init_dist_local(Nb, bnev, bnex, m, n,
                           B[i * m:(i + 1) * m, j * n:(j + 1) * n],
                           grid_shape=shape, pseudo=True, device="cpu")
        tf.set_tol(btol)
        _iface_solve(tf, rec, "iface/local_pseudo", warm=False)
    else:
        rec["iface/local/raises"] = expect_raise(
            ValueError, lambda: tf.init_dist_local(
                N, nev, nex, N // d0, N // d1, H[:N // d0, :N // d1],
                grid_shape=shape, device="cpu"), "dim0·dim1 | N")
    local = (N // d0, N // d1)
    rec["iface/refusals"] = [
        expect_raise(ValueError, lambda: tf.init(
            N, nev, nex, H, distributed=True, grid_shape=(d0 * d1 + 1, 1),
            device="cpu"), f"need {d0 * d1 + 1} ranks",
            f"has {d0 * d1}"),
        expect_raise(ValueError, lambda: tf.init_dist_local(
            N, nev, nex, local[0] + 1, local[1], H, grid_shape=shape,
            device="cpu"), "local block", "!= (N/dim0, N/dim1)") or
        N % (d0 * d1) != 0,
        expect_raise(ValueError, lambda: tf.init_dist_local(
            N, nev, nex, *local, H[:local[0], :local[1]],
            np.zeros((local[0], 3)), grid_shape=shape, device="cpu"),
            "V local block shape") or N % (d0 * d1) != 0,
        expect_raise(ValueError, lambda: tf.init_blockcyclic(
            N, nev, nex, mb, mb, H, grid_shape=shape, irsrc=1,
            device="cpu"), "irsrc/icsrc")]
    tf.finalize()


def case_iface_whole(grid, rec):
    """init(distributed=True) on the group's grid shape (Clement N=128):
    eigenvalues, the whole V and the ranks' coordinates."""
    import chase_tpu_torch.interface as tf
    from chase_tpu_torch.models import clement
    shape = (grid.size("r"), grid.size("c"))
    tf.init(128, 8, 8, clement(128), distributed=True, grid_shape=shape,
            device="cpu")
    tf.set_tol(1e-10)
    tf.set_deg(20)
    _iface_solve(tf, rec, "whole")
    rec["whole/local_rows"] = tf._require().op.H.shape[0]
    tf.finalize()


SOLVES_2D = (("clement_float64", {}), ("random_complex128", {}),
             ("clement_float64_ladder", {"ring_backend": "pallas",
                                         "mixed_precision": True}))
PSEUDO_2D = (("random_float64", {}), ("random_complex128", {}),
             ("random_float64_ladder", {"ring_backend": "pallas",
                                        "mixed_precision": True}))

PSEUDO = {
    "b21": (("random_float32", {"ring_backend": "pallas"}),
            ("random_complex64", {"ring_backend": "pallas"}),
            ("random_float64_ladder", {"ring_backend": "pallas",
                                       "mixed_precision": True})),
    "b31": (("random_float64_N130", {"warm": True}),),
    "b41": (("random_complex128", {"ring_backend": "pallas"}),),
    "b22": (("random_float64", {}),),
}
FUSED = {
    "f21": (("float64", {}), ("float32", {"ring_backend": "pallas"})),
    "f22": (("float64", {}),),
}

SOLVES = {
    "g11": (("clement_float64", {}), ("random_complex64", {})),
    "g12": (("clement_float64", {}), ("random_complex64", {})),
    "g22": (("clement_float32", {"ring_backend": "pallas"}),
            ("random_complex128", {})),
    "g21": (("clement_float32", {"ring_backend": "pallas"}),
            ("random_complex64", {"ring_backend": "pallas"})),
    "g41": (("clement_float64", {}),
            ("random_complex128", {"ring_backend": "pallas"}),
            ("clement_float64_N130", {"ring_backend": "pallas"}),
            ("clement_float64_ladder", {"ring_backend": "pallas",
                                        "mixed_precision": True})),
}

BATTERIES = {
    "g11": (case_mesh, case_solves(SOLVES["g11"]), case_bounds,
            case_fused_11, case_warmup),
    "g12": (case_mesh, case_hemm, case_solves(SOLVES["g12"]),
            case_sequence, case_bounds),
    "g22": (case_mesh, case_hemm, case_solves(SOLVES["g22"]),
            case_ring_filter_2d, case_bounds, case_dtensor_padded),
    "g8": (case_mesh,),
    "g21": (case_mesh, case_ring, case_filters),
    "g41": (case_ring, case_filters, case_tsqr),
    "g21s": (case_solves(SOLVES["g21"]), case_dtensor, case_warmup,
             case_bounds),
    "g41s": (case_solves(SOLVES["g41"]), case_bounds, case_dtensor_padded),
    "b21": (case_pseudo(PSEUDO["b21"]), case_sops, case_bse_pad),
    "b31": (case_pseudo(PSEUDO["b31"]), case_sops, case_bse_pad,
            case_bse_dtensor),
    "b41": (case_pseudo(PSEUDO["b41"]), case_sops, case_bse_pad),
    "b22": (case_pseudo(PSEUDO["b22"]), case_pseudo_ring_filter_2d,
            case_bse_dtensor),
    "f21": (case_fused(FUSED["f21"]), case_fused_warmup),
    "f22": (case_fused(FUSED["f22"]), case_fused_warmup),
    "r22": (case_passes2d, case_filters2d, case_grid_no_copy,
            case_suffix2d),
    "r23": (case_passes2d, case_filters2d),
    "s22": (case_ring_filter_values(solve_case, SOLVES_2D), case_sequence,
            case_fused2d),
    "p22": (case_ring_filter_values(pseudo_case, PSEUDO_2D),),
    "io22": (case_io, case_state, case_cli),
    "io21": (case_io, case_state, case_cli),
    "io12": (case_io, case_state, case_cli),
    "io31": (case_io, case_state, case_cli),
    "if22": (case_iface,),
    "if21": (case_iface,),
    "if12": (case_iface,),
    "if31": (case_iface,),
    "w21": (case_iface_whole,),
    "w12": (case_iface_whole,),
    "w22": (case_iface_whole,),
    "c22": (case_inplace, case_comm),
}


def main():
    global DIR
    battery, r, c, rank, rdv, out = sys.argv[1:7]
    DIR = out
    r, c, rank = int(r), int(c), int(rank)
    os.environ["RANK"], os.environ["WORLD_SIZE"] = str(rank), str(r * c)
    from chase_tpu_torch.parallel import multihost
    grid = multihost.init_grid((r, c), f"file://{rdv}", device="cpu",
                               timeout=120)
    rec = {}
    for case in BATTERIES[battery]:
        case(grid, rec)
    np.savez(os.path.join(out, f"rank{rank}.npz"),
             **{k: np.asarray(v) for k, v in rec.items()})
    import torch.distributed as dist
    dist.destroy_process_group()


# -- the launcher the tests use --------------------------------------------

class Group:
    """The R·C ranks of one battery, started at once as processes of this
    script (their output in ``tmp``/log<k>); :meth:`results` waits for
    them — at most ``timeout`` seconds from the start, then every rank is
    killed and the call raises — and returns each rank's records."""

    def __init__(self, battery: str, r: int, c: int, tmp, timeout=240):
        import subprocess
        import time
        from pathlib import Path
        self.tmp = Path(tmp)
        self.name = f"{battery} ({r}, {c})"
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                   PYTHONPATH=str(Path(__file__).resolve().parent.parent))
        self.logs = [open(self.tmp / f"log{k}", "w") for k in range(r * c)]
        self.procs = [subprocess.Popen(
            [sys.executable, __file__, battery, str(r), str(c), str(k),
             str(self.tmp / "rendezvous"), str(self.tmp)], env=env,
            stdout=log, stderr=log) for k, log in enumerate(self.logs)]
        self.deadline = time.monotonic() + timeout
        self._results = None

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in self.logs:
            log.close()

    def _log(self) -> str:
        return "\n".join(f"--- rank {k}\n" + (self.tmp / f"log{k}")
                         .read_text()[-3000:] for k in range(len(self.procs)))

    def results(self) -> list:
        import subprocess
        import time
        if self._results is None:
            try:
                for p in self.procs:
                    p.wait(timeout=max(1.0, self.deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                self.kill()
                raise AssertionError(f"grid {self.name} timed out\n"
                                     f"{self._log()}")
            self.kill()
            codes = [p.returncode for p in self.procs]
            if any(codes):
                raise AssertionError(f"grid {self.name}: exit codes "
                                     f"{codes}\n{self._log()}")
            self._results = [dict(np.load(self.tmp / f"rank{k}.npz"))
                             for k in range(len(self.procs))]
        return self._results


if __name__ == "__main__":
    try:
        main()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
