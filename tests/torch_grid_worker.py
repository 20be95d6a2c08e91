"""One rank of the PyTorch port's process-grid tests.

    python tests/torch_grid_worker.py BATTERY R C RANK RENDEZVOUS OUT_DIR

Joins a gloo process group of R·C ranks through the ``file://`` rendezvous
RENDEZVOUS (``multihost.init_grid``, RANK and WORLD_SIZE from the
environment it sets), builds the (R, C) grid, runs the battery of cases
named BATTERY and writes what each case computed to OUT_DIR/rank<k>.npz
(gathered multivectors whole, so that every rank's copy can be held to
the others').  ``tests/test_torch_grid.py``,
``tests/test_torch_grid_ring.py`` and ``tests/test_torch_grid_solve.py``
start the ranks and compare the results with the JAX package in their
own process.  This script imports torch,
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


def refine_inputs(H, X, deg):
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
    tabs = refine_tables(theta, deg, lam1, lo, up, DEG_FILT)
    return Q.astype(H.dtype), R.astype(H.dtype), tabs, (up + lo) / 2.0


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


# -- helpers ---------------------------------------------------------------

def full(grid, t: torch.Tensor) -> np.ndarray:
    """The whole multivector from this rank's rows."""
    return grid.all_gather(t.contiguous(), "r").numpy()


class _Counter:
    """Counts the ring's kernel steps: calls of ``ops.ring_hemm.ring_hemm``
    (looked up there by every ring product at call time)."""

    def __init__(self):
        from chase_tpu_torch.ops import ring_hemm as rh
        real, self.n = rh.ring_hemm, 0

        def counting(*a, **k):
            self.n += 1
            return real(*a, **k)
        rh.ring_hemm = counting

    def take(self) -> int:
        n, self.n = self.n, 0
        return n


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


def solve_case(grid, rec, name: str, **cfg):
    """eigsh on the grid and with grid=None (same seed) on the same H:
    spectra, residuals, iterations, locked count, the gathered V, and the
    ring's steps beside the filter's HEMM steps."""
    import chase_tpu_torch as ct
    H, nev, nex, tol = eig_problem(name)
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


def case_refusals(grid, rec):
    """Part 2's entry points refuse a grid larger than 1×1."""
    import chase_tpu_torch as ct
    from chase_tpu_torch.models import clement, random_pseudo_hermitian
    H = clement(64)
    Hp = random_pseudo_hermitian(64, np.float64, seed=5)
    rec["refuse/fused"] = expect_raise(
        NotImplementedError, lambda: ct.eigsh_fused(H, 4, 4, grid=grid),
        "part 2")
    rec["refuse/pseudo"] = expect_raise(
        NotImplementedError, lambda: ct.eigsh_pseudo(Hp, 4, 4, grid=grid),
        "part 2")
    rec["refuse/pseudo_fused"] = expect_raise(
        NotImplementedError,
        lambda: ct.eigsh_pseudo_fused(Hp, 4, 4, grid=grid), "part 2")
    rec["refuse/pseudo_operator"] = expect_raise(
        NotImplementedError,
        lambda: ct.DenseOperator(Hp, grid=grid, pseudo_hermitian=True),
        "part 2")
    rec["refuse/warmup_fused"] = expect_raise(
        NotImplementedError,
        lambda: ct.warmup(H, 4, 4, grid=grid, fused=True), "part 2")


def case_ring_filter_2d(grid, rec):
    """ring_filter=True on an r×c grid raises, naming part 3."""
    import chase_tpu_torch as ct
    from chase_tpu_torch.models import clement
    rec["refuse/ring_filter_2d"] = expect_raise(
        NotImplementedError, lambda: ct.eigsh(
            clement(64), 4, 4, grid=grid,
            config=ct.ChaseConfig(ring_filter=True)), "part 3")


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
    "g21s": (case_solves(SOLVES["g21"]), case_refusals, case_dtensor,
             case_warmup, case_bounds),
    "g41s": (case_solves(SOLVES["g41"]), case_bounds, case_dtensor_padded),
}


def main():
    battery, r, c, rank, rdv, out = sys.argv[1:7]
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
