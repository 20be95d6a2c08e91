"""Dense operator on one device or on a process grid.

Port of ``chase_tpu/parallel/operator.py``: the Hermitian or
pseudo-Hermitian (BSE, ``pseudo_hermitian=True``: even N, its S-halves
unpadded) operator H (f32, f64, c64 or c128) pinned on an explicit torch
device, with its dtype checked, and its reduced-precision shadow ``H_low``
for the precision ladder.  ``free_low`` drops the cached shadow.  The
transient and bf16-rebuilt shadows of the JAX package's wide-f64 mode
(``H_filter``, ``drop_shadow``, ``engage_wide``) are TPU workarounds and
are not ported.

On a grid (``DenseOperator(H, grid=grid)``, ``parallel/mesh.py``) the
operator keeps only this rank's block of ``P('r', 'c')`` on its card: rows
``[i·N/r, (i+1)·N/r)``, columns ``[j·N/c, (j+1)·N/c)``.  When N is not a
multiple of r·c it is padded to one, as in the JAX package, with decoupled
diagonal entries at the Gershgorin upper bound ``max_i(Σ_j |H_ij| + Re
H_ii − |H_ii|)`` (in H's dtype): the phantom eigenvalues lie above the
whole spectrum and never enter the wanted set; ``N_orig`` is the user's
size and :meth:`unpad_block` cuts the phantom rows off again.  H may be a
numpy array or tensor that every rank holds whole, or a DTensor sharded
``(Shard(0), Shard(1))`` on the grid's mesh (re-cut to the padded layout
point to point, never gathered).  A pseudo-Hermitian operator on a grid
larger than 1×1 waits for the S-preserving pad (ROADMAP queue 1 item 5,
part 2) and raises NotImplementedError.

A CUDA H — or block — of a dtype the ring kernel reads (f32, c64, and
bf16 for the f32 problem's shadow) is kept where the kernel's TMA loads
can read it without a copy: 16-byte aligned, with a row stride of a whole
number of 16 bytes — 4 f32 elements, 2 c64 elements (its float view's
rows are twice as long) or 8 bf16 elements.  When the width is not a
multiple of that it is the first columns of a wider allocation
(``padded_empty``).  f64 and c128 operators never reach the kernel and
are stored contiguous.  A tensor with torch's lazy conjugate or negative
bit (``H.conj()``) is copied, never kept as is: it shares the data of the
unconjugated matrix, which is what the kernel would read.

Placement never falls back: asking for a CUDA device on a machine without
one raises RuntimeError instead of solving on the CPU.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.ring_hemm import KERNEL_DTYPES, tma_ld, tma_row_stride
from ..types import as_torch_dtype, low_precision_dtype, real_dtype

__all__ = ["DenseOperator", "resolve_device", "padded_empty",
           "gershgorin_pad", "block_of"]

PART2 = ("ROADMAP queue 1 item 5, part 2 (BSE and the fused solvers on "
         "grids)")


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing CUDA when no card is visible;
    a bare "cuda" becomes the current card ("cuda:0"), so a tensor already
    there is recognized and not copied."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            f"False; chase_tpu_torch does not fall back to the CPU — pass "
            f"device='cpu' to solve there")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_for(device, grid) -> torch.device:
    """The device of a solve: the grid's (``device`` must then be None
    or name it), else ``device`` ("cuda" when None)."""
    if grid is None:
        return resolve_device("cuda" if device is None else device)
    if device is not None and resolve_device(device) != grid.device:
        raise ValueError(f"device {str(device)!r} is not the grid's "
                         f"device {grid.device}")
    return grid.device


def _numpy_to(arr: np.ndarray, device: torch.device, dtype) -> torch.Tensor:
    """A copy of ``arr`` on ``device`` in the array's own strides: a
    Fortran-ordered array (``io.load_matrix``'s) is copied as it lies, not
    transposed on the host."""
    if any(s < 0 for s in arr.strides):       # torch takes no negative stride
        arr = arr.copy()
    return torch.tensor(arr, dtype=dtype, device=device)


def to_device(a, device: torch.device, dtype=None) -> torch.Tensor:
    """Copy a numpy array or tensor onto ``device`` (never aliasing the
    caller's host buffer — the solver updates its blocks in place).  A
    numpy array lands row-major whatever its order, transposed where it
    lands (the ring kernel's plain version takes unit column stride
    only)."""
    if isinstance(a, torch.Tensor):
        t = a.to(device=device, dtype=dtype or a.dtype)
        if t.is_conj() or t.is_neg():
            return t.resolve_conj().resolve_neg()
        return t.clone() if t is a else t
    arr = np.asarray(a)
    dt = dtype if dtype is not None else as_torch_dtype(arr.dtype)
    return _numpy_to(arr, device, dt).contiguous()


def padded_empty(N: int, dtype, device, cols: Optional[int] = None
                 ) -> torch.Tensor:
    """An uninitialised (N, cols) tensor (cols = N by default) laid out as
    a CUDA operator is stored: for the kernel's dtypes a view whose row is
    rounded up to a whole number of 16 bytes (``tma_ld``): the width
    rounded up to a multiple of 4 for float32, to an even number for
    complex64, to a multiple of 8 for bfloat16.  Otherwise contiguous."""
    cols = N if cols is None else cols
    ld = cols
    if dtype in KERNEL_DTYPES:
        w = 2 if dtype.is_complex else 1        # TMA units per element
        ld = tma_ld(w * cols, dtype.itemsize // w) // w
    return torch.empty((N, ld), dtype=dtype, device=device)[:, :cols]


def _has_operator_layout(H: torch.Tensor) -> bool:
    """Whether H already has a layout :func:`padded_empty`'s rule accepts
    (and no lazy conjugate or negative bit)."""
    if H.is_conj() or H.is_neg():
        return False
    if H.dtype in KERNEL_DTYPES:
        return H.stride(1) == 1 and tma_row_stride(H) is not None
    return H.is_contiguous()


def gershgorin_pad(H) -> torch.Tensor:
    """The padding's diagonal value, the JAX package's Gershgorin upper
    bound ``max_i(Σ_j |H_ij| + Re H_ii − |H_ii|)`` in H's dtype (a 0-d
    tensor), for a whole H (numpy or tensor)."""
    Ht = H if isinstance(H, torch.Tensor) else torch.as_tensor(np.asarray(H))
    d = torch.diagonal(Ht)
    return torch.max(torch.sum(torch.abs(Ht), dim=1) + d.real
                     - torch.abs(d)).to(Ht.dtype)


def block_of(H, rows: tuple, cols: tuple, N: int, *, dtype, device,
             pad=None) -> torch.Tensor:
    """The block [r0, r0 + nr) × [c0, c0 + nc) of H padded to N × N
    (``rows = (r0, nr)``, ``cols = (c0, nc)``), in the operator layout of
    :func:`padded_empty` on ``device``: H's entries where they exist, the
    diagonal ``pad`` value on the phantom diagonal (rows ≥ H's size),
    zeros elsewhere.  H is a whole numpy array or tensor; only the block's
    part of it is copied."""
    (r0, nr), (c0, nc) = rows, cols
    n = int(H.shape[0])
    part = H[r0:max(r0, min(r0 + nr, n)), c0:max(c0, min(c0 + nc, n))]
    if not isinstance(part, torch.Tensor):
        part = _numpy_to(np.asarray(part), device, dtype)
    return _padded_block(part, rows, cols, n, N, dtype=dtype, device=device,
                         pad=pad)


def _padded_block(part: torch.Tensor, rows: tuple, cols: tuple, n: int,
                  N: int, *, dtype, device, pad=None) -> torch.Tensor:
    """:func:`block_of` from ``part``, the entries of an n × n H that lie
    in the block (its first rows and columns)."""
    (r0, nr), (c0, nc) = rows, cols
    out = padded_empty(nr, dtype, device, nc)
    if tuple(part.shape) != (nr, nc):
        out.zero_()
    if part.numel():
        out[:part.shape[0], :part.shape[1]].copy_(part)
    lo, hi = max(n, r0, c0), min(r0 + nr, c0 + nc, N)
    if hi > lo:
        k = torch.arange(lo, hi, device=device)
        out[k - r0, k - c0] = torch.as_tensor(pad, device=device).to(dtype)
    return out


def _pieces(n: int, p: int, size: int) -> list:
    """[start, stop) of each of the p pieces of an n-long dimension cut in
    pieces of ``size`` (the last ones short or empty)."""
    return [(min(k * size, n), min((k + 1) * size, n)) for k in range(p)]


def _recut(t: torch.Tensor, grid, axis: str, dim: int, src: list,
           dst: list) -> torch.Tensor:
    """Re-cut dimension ``dim`` of a tensor cut over ``axis``: this rank
    holds piece ``src[me]`` and gets ``dst[me]``, the overlaps passed
    point to point within the axis group (no member holds more than its
    two pieces)."""
    import torch.distributed as dist
    from .mesh import _wire
    me = grid.index(axis)
    (s0, s1), (d0, d1) = src[me], dst[me]
    shape = list(t.shape)
    shape[dim] = d1 - d0
    out = torch.empty(shape, dtype=t.dtype, device=t.device)
    ops, recvs = [], []
    for k in range(grid.size(axis)):
        a, b = max(s0, dst[k][0]), min(s1, dst[k][1])      # mine, k's rows
        if k == me:
            if b > a:
                out.narrow(dim, a - d0, b - a).copy_(t.narrow(dim, a - s0,
                                                              b - a))
            continue
        peer = grid.global_rank(axis, k)
        if b > a:
            piece = t.narrow(dim, a - s0, b - a).contiguous()
            grid.stats.add("sendrecv", piece)
            ops.append(dist.P2POp(dist.isend, _wire(piece), peer,
                                  grid.group(axis)))
        a, b = max(src[k][0], d0), min(src[k][1], d1)      # k's, my rows
        if b > a:
            shape[dim] = b - a
            buf = torch.empty(shape, dtype=t.dtype, device=t.device)
            recvs.append((buf, a))
            ops.append(dist.P2POp(dist.irecv, _wire(buf), peer,
                                  grid.group(axis)))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for buf, a in recvs:
        out.narrow(dim, a - d0, buf.shape[dim]).copy_(buf)
    return out


def _sharded_gershgorin_pad(L: torch.Tensor, grid, rows: tuple,
                            cols: tuple) -> torch.Tensor:
    """:func:`gershgorin_pad` of the H whose piece [rows) × [cols) this
    rank holds as ``L`` (the grid's (Shard(0), Shard(1)) cut): row sums
    summed over 'c', their maximum over 'r' — the same bits on every
    rank."""
    import torch.distributed as dist
    a = torch.sum(torch.abs(L), dim=1)
    g0, g1 = max(rows[0], cols[0]), min(rows[1], cols[1])
    if g1 > g0:
        k = torch.arange(g0, g1, device=L.device)
        d = L[k - rows[0], k - cols[0]]
        a[k - rows[0]] += d.real - torch.abs(d)
    if rows[1] > rows[0]:
        a = grid.all_reduce(a.contiguous(), "c")
    m = torch.full((1,), -torch.inf, dtype=a.dtype, device=a.device)
    if a.numel():
        m[0] = torch.max(a)
    return grid.all_reduce(m, "r", op=dist.ReduceOp.MAX)[0].to(L.dtype)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


class DenseOperator:
    """Dense Hermitian (or, with ``pseudo_hermitian``, BSE) operator
    resident on one torch device, or this rank's block of it on a
    grid."""

    def __init__(self, H, device=None, *, grid=None,
                 pseudo_hermitian: bool = False):
        self.grid = grid
        self.device = device_for(device, grid)
        if H.ndim != 2 or H.shape[0] != H.shape[1]:
            raise ValueError(f"H must be square, got {tuple(H.shape)}")
        if pseudo_hermitian and H.shape[0] % 2:
            raise ValueError(f"a pseudo-Hermitian operator needs even N "
                             f"(the metric S splits it in halves), got N = "
                             f"{H.shape[0]}")
        if pseudo_hermitian and grid is not None and grid.nprocs > 1:
            raise NotImplementedError(
                f"a pseudo-Hermitian operator on the grid {grid.shape} needs "
                f"the S-preserving pad, {PART2}")
        self.pseudo_hermitian = bool(pseudo_hermitian)
        dtype = as_torch_dtype(H.dtype)
        real_dtype(dtype)         # TypeError for a dtype the solver lacks
        self._H_low = None
        self.N_orig = int(H.shape[0])
        if grid is None:
            self._N = self.N_orig
            self.H = self._place(H, dtype)
        else:
            self._place_grid(H, dtype)

    def _place(self, H, dtype) -> torch.Tensor:
        """The whole H on one device, in the operator layout."""
        resident = isinstance(H, torch.Tensor) and H.device == self.device
        if self.device.type == "cuda":
            if resident and _has_operator_layout(H):
                return H          # used as is (no N² copy)
            out = padded_empty(H.shape[0], dtype, self.device)
            return out.copy_(H if isinstance(H, torch.Tensor)
                             else _numpy_to(np.asarray(H), self.device,
                                            dtype))
        if resident:
            # a device-resident operator is used as is (no N² copy),
            # unless it is a lazy conjugate or negative view
            lazy = H.is_conj() or H.is_neg()
            return H if H.is_contiguous() and not lazy \
                else H.resolve_conj().resolve_neg().contiguous()
        return to_device(H, self.device)

    def _place_grid(self, H, dtype) -> None:
        """This rank's block of H padded to a multiple of r·c."""
        r, c = self.grid.size("r"), self.grid.size("c")
        tile = r * c
        N = self.N_orig
        self._N = -(-N // tile) * tile
        rows = self.grid.block(self._N, "r")
        cols = self.grid.block(self._N, "c")
        if _is_dtensor(H):
            self.H = self._sharded_block(H, dtype, rows, cols)
            return
        if tile == 1:
            # the whole H is this rank's block: placed as on one device
            # (a resident H in the operator layout is used as is)
            self.H = self._place(H, dtype)
            return
        if isinstance(H, torch.Tensor) and (H.is_conj() or H.is_neg()):
            H = H.resolve_conj().resolve_neg()
        pad = gershgorin_pad(H) if self._N != N else None
        self.H = block_of(H, rows, cols, self._N, dtype=dtype,
                          device=self.device, pad=pad)

    def _sharded_block(self, H, dtype, rows: tuple,
                       cols: tuple) -> torch.Tensor:
        """This rank's block of a DTensor H, never gathered: a ``(Shard(0),
        Shard(1))`` H on the grid's mesh is re-cut from DTensor's even
        split of N_orig to the padded layout point to point
        (:func:`_recut`) and padded with the Gershgorin diagonal from its
        pieces' row sums.  ValueError for any other layout."""
        from torch.distributed.tensor import Shard
        placements = tuple(H.placements)
        mesh, want = H.device_mesh.mesh.tolist(), self.grid.mesh.mesh.tolist()
        if placements != (Shard(0), Shard(1)) or mesh != want:
            raise ValueError(
                f"a DTensor H must be sharded (Shard(0), Shard(1)) on the "
                f"grid's mesh {want}; got {placements} on {mesh}")
        N, Np = self.N_orig, self._N
        r, c = self.grid.size("r"), self.grid.size("c")
        i, j = self.grid.coords
        src_r, src_c = _pieces(N, r, -(-N // r)), _pieces(N, c, -(-N // c))
        L = H.to_local().resolve_conj().resolve_neg()
        pad = None
        if Np != N:
            pad = _sharded_gershgorin_pad(L, self.grid, src_r[i], src_c[j])
            L = _recut(L, self.grid, "r", 0, src_r, _pieces(N, r, Np // r))
            L = _recut(L, self.grid, "c", 1, src_c, _pieces(N, c, Np // c))
        return _padded_block(L, rows, cols, N, Np, dtype=dtype,
                             device=self.device, pad=pad)

    @property
    def N(self) -> int:
        """The operator's size (padded to a multiple of r·c on a grid)."""
        return self._N

    @property
    def dtype(self) -> torch.dtype:
        return self.H.dtype

    @property
    def real_dtype(self) -> torch.dtype:
        """The real scalar type of H's dtype (f32 for c64, f64 for c128)."""
        return real_dtype(self.dtype)

    @property
    def rows(self) -> tuple:
        """(first row, row count) of this rank's blocks: (0, N) off a
        grid."""
        return (0, self._N) if self.grid is None \
            else self.grid.block(self._N, "r")

    def free_low(self) -> None:
        """Drop the cached shadow ``H_low`` — N² elements of device memory
        between solves (7.2 GB for the c128 north star's c64 shadow); the
        next ``H_low`` rebuilds it."""
        self._H_low = None

    @property
    def H_low(self) -> torch.Tensor:
        """H (this rank's block, on a grid) in ``low_precision_dtype``
        (f64 → f32, c128 → c64, f32 → bf16): the precision ladder's filter
        operator, built on first use and cached (the JAX package's
        ``H_low`` without its transient mode).  On CUDA it is laid out as
        ``padded_empty`` lays out an operator, so the ring kernel reads it
        without a copy."""
        if self._H_low is None:
            lp = low_precision_dtype(self.dtype)
            if self.device.type == "cuda":
                self._H_low = padded_empty(self.H.shape[0], lp, self.device,
                                           self.H.shape[1])
                self._H_low.copy_(self.H)
            else:
                self._H_low = self.H.to(lp)
        return self._H_low

    def local_rows(self, V: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole (N, k) multivector (a view; V
        itself off a grid)."""
        if self.grid is None:
            return V
        r0, n = self.rows
        return V[r0:r0 + n]

    def place_block(self, V) -> torch.Tensor:
        """A private copy of this rank's rows of a multivector, on the
        operator's device in the operator's dtype.  V is whole (N_orig or
        N rows; the phantom rows of a padded operator are zero) or, on a
        grid, a DTensor ``(Shard(0), Replicate())`` as ``eigsh`` returns
        it (its local rows taken where the layouts agree)."""
        if self.grid is None:
            if V.shape[0] != self.N:
                raise ValueError(f"block has {V.shape[0]} rows, operator "
                                 f"N = {self.N}")
            return to_device(V, self.device, self.dtype)
        if V.shape[0] not in (self.N_orig, self.N):
            raise ValueError(f"block has {V.shape[0]} rows, operator N = "
                             f"{self.N_orig} (padded {self.N})")
        r0, n = self.rows
        if _is_dtensor(V):
            local = _local_rows_of(V, self.grid, n)
            V, r0 = (V.full_tensor(), r0) if local is None else (local, 0)
        part = V[r0:r0 + n]
        if not isinstance(part, torch.Tensor):
            part = torch.as_tensor(np.asarray(part))
        out = torch.zeros((n, V.shape[1]), dtype=self.dtype,
                          device=self.device)
        out[:part.shape[0]] = part.resolve_conj().resolve_neg()
        return out

    def unpad_block(self, V: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a result multivector without the phantom
        rows of a padded operator (V itself when nothing was padded)."""
        if self.N == self.N_orig:
            return V
        r0 = self.rows[0]
        return V[:max(0, min(V.shape[0], self.N_orig - r0))]


def _local_rows_of(V, grid, n: int) -> Optional[torch.Tensor]:
    """A ``(Shard(0), Replicate())`` DTensor's local rows when they are
    this rank's rows of the grid's layout (the valid part of an n-row
    block), else None."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = V.device_mesh
    r = grid.size("r")
    if (tuple(V.placements) != (Shard(0), Replicate())
            or tuple(mesh.shape) != (r, grid.size("c"))
            or tuple(mesh.get_coordinate()) != grid.coords
            or -(-V.shape[0] // r) != n):
        return None
    return V.to_local()
