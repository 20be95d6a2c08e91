"""The port's 2-D ping-pong rings on r×c process grids against the JAX
package: ``parallel.ring.Ring2D``'s two passes, the four 2-D ring filters
(``chebyshev_filter_ring2d``, ``chebyshev_filter_refine_ring2d``,
``chebyshev_filter_h2_ring2d``, ``chebyshev_filter_refine_h2_ring2d``),
and that both passes read the rank's block itself, on (2, 2) and (2, 3)
gloo grids.

The groups are started once for this module, as in
``tests/test_torch_grid.py`` (``tests/torch_grid_worker.py``, a hard time
limit each).  On the CPU every kernel step is ``ring_hemm``'s plain
version (the tensors lie on the CPU); the steps are counted where the
rings call it.  Tolerances:

* ``ring_A`` (H·w, parity A → B) and ``ring_B`` (Hᴴ·w, B → A) of a
  general H against the dense products' chunks: 1e-12 of the largest
  entry in f64 and c128, 1e-5 in f32, c64 and on the f32 and bf16
  shadows (f32 sums; the bf16 case against the product of the
  bf16-rounded operands); r kernel steps per ring_A pass and c per
  ring_B pass where the operator is one the kernel takes, else none;
* each 2-D filter, deg_max 6 and 7 (the entry parities differ), mixed
  degrees with degree-0 columns, against ``chase_tpu.parallel.ring``'s
  function of the same name on a mesh of the same shape and against the
  port's p = 1 filter on the whole operator: per column within 1e-12 of
  its largest entry in f64 and c128, 1e-5 in f32, c64 and for the f64
  window on the f32 shadow, 1e-2 for the f32 window on the bf16 shadow
  (each product rounds its input to bf16, at other places than XLA);
  degree-0 columns bit-exact; kernel launches per rank as the module
  note of ``parallel/ring.py`` states;
* no copy: every kernel step of both passes reads the rank's filter
  operator (ring_B's on the ``trans=True`` route), and neither the
  operator nor the ring holds another tensor;
* the live suffix on (2, 2): the Hermitian and refine 2-D filters on a
  window wider than a W tile (f64 on torch.matmul, c64 and a c128 window
  on its c64 shadow on the kernel), sorted, unsorted and equal degrees
  after a pad of degree 0, against the full-width recurrence on the whole
  operator (``torch_grid_worker.full_width_*``): 1e-12 / 1e-5 relative
  per column, degree-0 columns bit-exact, each kernel step as wide as its
  step's suffix in 64-column tiles.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chase_tpu
from chase_tpu.parallel import ring as jring

import torch_grid_worker as gw

torch.set_num_threads(1)

SHAPES = {"r22": (2, 2), "r23": (2, 3)}
CASES = {c[0]: c for c in gw.FILTER_CASES_2D}
KERNEL = {"f64": False, "c128": False, "f32": True, "c64": True,
          "f64_on_f32": True, "f32_on_bf16": True}


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    started = {name: gw.Group(name, r, c, tmp_path_factory.mktemp(name))
               for name, (r, c) in SHAPES.items()}
    yield started
    for g in started.values():
        g.kill()


def _jax_grid(shape):
    n = shape[0] * shape[1]
    return chase_tpu.make_grid(jax.devices()[:n], shape=shape)


def _col_rel(Y, ref):
    """max over columns of ‖Y_j − ref_j‖∞ / ‖ref_j‖∞."""
    num = np.abs(Y - ref).max(axis=0)
    den = np.maximum(np.abs(ref).max(axis=0), np.finfo(np.float64).tiny)
    return float((num / den).max())


def _tol(case):
    if case in ("f64", "c128"):
        return 1e-12
    return 1e-2 if case == "f32_on_bf16" else 1e-5


@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("case", list(CASES))
def test_passes_match_dense(groups, name, case):
    r, c = SHAPES[name]
    nch = gw.N_FILT // (r * c)
    for rec in groups[name].results():
        H, X = rec[f"pass/{case}/H"], rec[f"pass/{case}/X"]
        if case == "f32_on_bf16":        # the kernel's bf16 route rounds V
            X = torch.from_numpy(X).to(torch.bfloat16).double().numpy()
        X = X.astype(np.complex128)
        a, b = (int(x) for x in rec["pass/chunks"])
        for key, ref, chunk in (("passA", H @ X, b),
                                ("passB", H.conj().T @ X, a)):
            want = ref[chunk * nch:(chunk + 1) * nch]
            got = rec[f"{key}/{case}"]
            tol = 1e-12 if case in ("f64", "c128") else 1e-5
            assert np.abs(got - want).max() <= tol * np.abs(ref).max(), key
        steps = (int(rec[f"passA/{case}/steps"]),
                 int(rec[f"passB/{case}/steps"]))
        assert steps == ((r, c) if KERNEL[case] else (0, 0))


def _jax_filter(kind, jgrid, case, dm):
    """The JAX package's 2-D filter of ``kind`` on the worker's inputs."""
    _, dt, shadow, seed = CASES[case]
    deg = gw.filter_degrees(deg_max=dm)
    if kind in ("f2d", "r2d"):
        H, X, lam1, lo, up = gw.problem(gw.N_FILT, gw.W_FILT, dt, seed)
    else:
        H, X, lam1, lo, up = gw.bse_filter_problem(gw.N_FILT, gw.W_FILT, dt,
                                                   seed)
    Hj = jnp.asarray(H) if shadow is None else jnp.asarray(
        H, getattr(jnp, shadow))
    Hj = jax.device_put(Hj, jgrid.sharding("r", "c"))
    degj = jnp.asarray(deg)
    if kind == "f2d":
        Y = jring.chebyshev_filter_ring2d(jgrid, Hj, jnp.asarray(X), degj,
                                          lam1, lo, up, dm)
        first = X
    elif kind == "h2d":
        Y = jring.chebyshev_filter_h2_ring2d(jgrid, Hj, jnp.asarray(X), degj,
                                             lam1, lo, up, dm)
        first = X
    else:
        V, R, tabs, cc = (gw.refine_inputs(H, X, deg, dm) if kind == "r2d"
                          else gw.refine_h2_inputs(H, X, deg, lam1, lo, up,
                                                   dm))
        fn = (jring.chebyshev_filter_refine_ring2d if kind == "r2d"
              else jring.chebyshev_filter_refine_h2_ring2d)
        Y = fn(jgrid, Hj, jnp.asarray(V), jnp.asarray(R), degj, *tabs, cc,
               dm)
        first = V
    return np.asarray(Y), first, deg


def _launches(kind, r, c, dm):
    """ring_hemm launches per rank of one 2-D filter (ring.py's note)."""
    n = max(dm - 1, 0) if kind in ("r2d", "rh2d") else max(dm, 1)
    if kind in ("f2d", "r2d"):
        return -(-n // 2) * r + (n // 2) * c
    return n * (r + c)


@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("kind", ["f2d", "r2d", "h2d", "rh2d"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dm", gw.DEGS_2D)
def test_filter2d_matches_jax_and_p1(groups, name, kind, case, dm):
    r, c = SHAPES[name]
    Yj, first, deg = _jax_filter(kind, _jax_grid(SHAPES[name]), case, dm)
    tol = _tol(case)
    zero = deg == 0
    key = f"{kind}/{case}/{dm}"
    for rec in groups[name].results():
        Y, Y1 = rec[key], rec[f"{key}/p1"]
        assert Y.dtype == first.dtype
        assert _col_rel(Y[:, ~zero], Yj[:, ~zero]) <= tol
        assert _col_rel(Y[:, ~zero], Y1[:, ~zero]) <= tol
        np.testing.assert_array_equal(Y[:, zero], first[:, zero])
        want = _launches(kind, r, c, dm) if KERNEL[case] else 0
        assert int(rec[f"{key}/steps"]) == want


def test_grid_ring2d_reads_the_block_itself(groups):
    """Every kernel step of both passes reads the rank's filter operator
    (the c64 shadow of a c128 block): ring_A's r steps as they lie,
    ring_B's c steps on the trans route; the operator holds its block and
    shadow and nothing else, and the ring no tensor of its own."""
    r, c = SHAPES["r22"]
    for rec in groups["r22"].results():
        reads = [tuple(bool(x) for x in st) for st in rec["nocopy/reads"]]
        assert reads == [(True, False)] * r + [(True, True)] * c
        assert list(rec["nocopy/op_tensors"]) == ["H", "_H_low"]
        assert list(rec["nocopy/ring_tensors"]) == ["H"]
        assert bool(rec["nocopy/ring_H_is_shadow"])


class _FakeGrid:
    """What Ring2D reads of a (2, 2) grid, for its argument checks."""

    def size(self, axis):
        return 2

    def index(self, axis):
        return 0

    def exchange(self, axis):
        return None


@pytest.mark.parametrize("kernel", [True, False], ids=["kernel", "matmul"])
def test_ring2d_holds_no_copy_of_the_block(kernel):
    """Ring2D keeps the block it is given, refuses a block of the wrong
    shape, and its ring_B steps read that block transposed in place (the
    trans route, or ``H[sub, :].mH`` on torch.matmul)."""
    from chase_tpu_torch.parallel.ring import Ring2D
    H = torch.randn(8, 8, dtype=torch.complex64)
    with pytest.raises(ValueError, match="block of"):
        Ring2D(_FakeGrid(), H[:, :6], kernel)
    ring = Ring2D(_FakeGrid(), H, kernel)
    assert ring.H is H
    assert [k for k, v in vars(ring).items()
            if isinstance(v, torch.Tensor)] == ["H"]
    assert (ring.step is None) == kernel


def test_fused_route_keeps_dist_hemm_on_2d(monkeypatch):
    """The one routing rule, ``parallel/ring.filter_product``: on "2d"
    the host solvers' product is the 2-D ring, its steps on the kernel
    with "pallas" and an f32 block, else on torch.matmul; the fused
    solvers (``fused.FilterProducts`` with the rule bound as
    ``api._fused_setup`` binds it) take ``dist.hemm`` there — no ring,
    no kernel — and the kernel's product on the other routes, and
    ``dist.hemm`` wherever the step is not the kernel."""
    from chase_tpu_torch import fused as tfused
    from chase_tpu_torch.parallel import ring as tring
    f32, f64 = torch.zeros(8, 8), torch.zeros(8, 8, dtype=torch.float64)
    for H, pallas, kernel in ((f32, True, True), (f32, False, False),
                              (f64, True, False)):
        prod = tring.filter_product("2d", H, _FakeGrid(), pallas)
        assert isinstance(prod.ring2d, tring.Ring2D) and prod.hemm is None
        assert prod.kernel is kernel
        assert (prod.ring2d.step is None) is kernel
        assert prod.tile == (128 if kernel else 1)

    class Grid21(_FakeGrid):
        def size(self, axis):
            return 2 if axis == "r" else 1

        shape = {"r": 2, "c": 1}

    monkeypatch.setattr(tring, "ring_steps", lambda *a, **k: "ring")
    monkeypatch.setattr(tfused, "hemm", lambda *a: "dist.hemm")
    X = torch.zeros(8, 3)

    def fused(route, pallas, grid, H=f32):
        chunk = functools.partial(tring.filter_product, route, pallas=pallas)
        return tfused.FilterProducts(chunk, grid)(H, X)

    assert fused("2d", True, _FakeGrid()) == "dist.hemm"
    assert fused("2d", True, _FakeGrid(),
                 torch.zeros(8, 8, dtype=torch.bfloat16)) == "dist.hemm"
    assert fused("1d", True, Grid21()) == "ring"
    assert fused("1d", False, Grid21()) == "dist.hemm"
    assert fused("1d", True, Grid21(), f64) == "dist.hemm"
    assert fused("p1", True, None) == "ring"
    assert fused(None, True, None) == "dist.hemm"


SUFFIX = {c[0]: c for c in gw.SUFFIX_CASES_2D}


@functools.lru_cache(maxsize=None)
def _suffix_problem(case):
    _, dt, _, seed = SUFFIX[case]
    return gw.problem(gw.N_SUF, gw.W_SUF, dt, seed)


@pytest.mark.parametrize("kind", gw.SUFFIX_DEGREES)
@pytest.mark.parametrize("case", list(SUFFIX))
@pytest.mark.parametrize("filt", ["f", "r"], ids=["filter", "refine"])
def test_suffix2d_matches_full_width(groups, filt, case, kind):
    H, X, lam1, lo, up = _suffix_problem(case)
    deg = gw.suffix_degrees(kind)
    Hw = gw._whole_op(H, SUFFIX[case][2])
    key = f"suf2d/{case}/{kind}/{filt}"
    if filt == "f":
        ref = gw.full_width_filter(Hw, torch.from_numpy(X), deg, lam1, lo,
                                   up, gw.DEG_SUF)
        first_in, first = X, 1
    else:
        V, R, tabs, cc = gw.suffix_refine_inputs(H, X, deg, lam1, lo, up)
        ref = gw.full_width_refine(Hw, torch.from_numpy(V),
                                   torch.from_numpy(R), deg, *tabs, cc,
                                   gw.DEG_SUF)
        first_in, first = V, 2
    ref = ref.numpy()
    zero = deg == 0
    tol = 1e-12 if case == "f64" else 1e-5
    r, c = SHAPES["r22"]
    for rec in groups["r22"].results():
        Y = rec[key]
        assert Y.dtype == first_in.dtype
        assert _col_rel(Y[:, ~zero], ref[:, ~zero]) <= tol
        np.testing.assert_array_equal(Y[:, zero], first_in[:, zero])
        launched = [int(w) for w in rec[f"{key}/widths"]]
        if case == "f64":
            assert launched == []
            continue
        # each step one pass of r (ring_A) or c (ring_B) kernel steps
        assert launched == [w for w in gw.suffix_widths(deg, first, 64)
                            for _ in range(r)]
        full = gw.W_SUF * (gw.DEG_SUF - first + 1) * r
        assert sum(launched) < 0.8 * full if kind == "sorted" else (
            sum(launched) <= full)
