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
size and :meth:`unpad_block` cuts the phantom rows off again.  A
pseudo-Hermitian operator takes the S-preserving pad instead: each half
pads on its own to ``h_pad = ceil(N/2 / (r·c))·(r·c)``, H's quadrants
land at ``[0, N/2)`` and ``[h_pad, h_pad + N/2)``, and the phantom
diagonal is ``+g`` in the upper pad and ``−g`` in the lower, g = ``max_i
Σ_j |H_ij|`` (:func:`magnitude_pad`): the metric S = diag(I, −I) keeps its
half split, and the phantom pairs ±g sit at the top of the H² interval
(``half`` holds (N/2, h_pad)).  H may be a numpy array or tensor that every
rank holds whole, or a DTensor sharded ``(Shard(0), Shard(1))`` on the
grid's mesh (re-cut to the padded layout point to point, never gathered).

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

The 2-D ring's second pass multiplies by this rank's block conjugate
transposed; the kernel reads it so in place (``ring_hemm(...,
trans=True)``), so the operator holds no second copy of the block.

Placement never falls back: asking for a CUDA device on a machine without
one raises RuntimeError instead of solving on the CPU.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.ring_hemm import KERNEL_DTYPES, tma_ld, tma_row_stride
from ..perf import host_sync, span
from ..types import as_torch_dtype, low_precision_dtype, real_dtype

__all__ = ["DenseOperator", "resolve_device", "padded_empty",
           "gershgorin_pad", "magnitude_pad", "block_of"]


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
    host_sync("operator.to_device")
    return torch.tensor(arr, dtype=dtype, device=device)


def to_device(a, device: torch.device, dtype=None) -> torch.Tensor:
    """Copy a numpy array or tensor onto ``device`` (never aliasing the
    caller's host buffer — the solver updates its blocks in place).  A
    numpy array lands row-major whatever its order, transposed where it
    lands (the ring kernel's plain version takes unit column stride
    only)."""
    if isinstance(a, torch.Tensor):
        if a.device != device:
            host_sync("operator.to_device")
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


def magnitude_pad(H) -> torch.Tensor:
    """The S-preserving pad's g, the JAX package's Gershgorin magnitude
    bound ``max_i Σ_j |H_ij|`` in H's dtype (a 0-d tensor), for a whole H:
    the phantom pairs ±g square to the top of the H² interval."""
    Ht = H if isinstance(H, torch.Tensor) else torch.as_tensor(np.asarray(H))
    return torch.max(torch.sum(torch.abs(Ht), dim=1)).to(Ht.dtype)


def _row_map(n: int, half) -> list:
    """[(padded start, H's start, count)]: where H's n rows (and columns)
    lie in the padded operator — in one piece, or with ``half = (n/2,
    h_pad)`` the S-preserving pad's two halves."""
    if half is None:
        return [(0, 0, n)]
    n_half, h_pad = half
    return [(0, 0, n_half), (h_pad, n_half, n_half)]


def _phantoms(n: int, N: int, half, pad) -> list:
    """[(first, stop, value)]: the phantom diagonal of H padded to N."""
    if half is None:
        return [(n, N, pad)]
    n_half, h_pad = half
    return [(n_half, h_pad, pad), (h_pad + n_half, N, -pad)]


def source_rows(n: int, half, start: int, count: int) -> list:
    """[(H's start, H's stop, offset)]: the rows of H that the padded rows
    [start, start + count) hold, each run at its offset in that range."""
    out = []
    for d0, s0, m in _row_map(n, half):
        a, b = max(start, d0), min(start + count, d0 + m)
        if b > a:
            out.append((s0 + a - d0, s0 + b - d0, a - start))
    return out


def block_of(H, rows: tuple, cols: tuple, N: int, *, dtype, device,
             pad=None, half=None) -> torch.Tensor:
    """The block [r0, r0 + nr) × [c0, c0 + nc) of H padded to N × N
    (``rows = (r0, nr)``, ``cols = (c0, nc)``), in the operator layout of
    :func:`padded_empty` on ``device``: H's entries where they exist, the
    diagonal ``pad`` value on the phantom diagonal (rows ≥ H's size; with
    ``half``, the S-preserving pad: +pad in the upper pad, −pad in the
    lower), zeros elsewhere.  H is a whole numpy array or tensor; only the
    block's part of it is copied."""
    (r0, nr), (c0, nc) = rows, cols
    n = int(H.shape[0])
    pieces = []
    for a0, a1, ro in source_rows(n, half, r0, nr):
        for b0, b1, co in source_rows(n, half, c0, nc):
            part = H[a0:a1, b0:b1]
            if not isinstance(part, torch.Tensor):
                part = _numpy_to(np.asarray(part), device, dtype)
            pieces.append((part, ro, co))
    return _padded_block(pieces, rows, cols, _phantoms(n, N, half, pad),
                         dtype=dtype, device=device)


def _padded_block(pieces, rows: tuple, cols: tuple, phantoms, *, dtype,
                  device) -> torch.Tensor:
    """:func:`block_of` from ``pieces`` — (part, row offset, column
    offset) of H's entries in the block — and the phantom diagonal."""
    (r0, nr), (c0, nc) = rows, cols
    out = padded_empty(nr, dtype, device, nc)
    if sum(p.shape[0] * p.shape[1] for p, _, _ in pieces) != nr * nc:
        out.zero_()
    for part, ro, co in pieces:
        if part.numel():
            out[ro:ro + part.shape[0], co:co + part.shape[1]].copy_(part)
    for k0, k1, value in phantoms:
        lo, hi = max(k0, r0, c0), min(k1, r0 + nr, c0 + nc)
        if hi > lo:
            k = torch.arange(lo, hi, device=device)
            out[k - r0, k - c0] = torch.as_tensor(value,
                                                  device=device).to(dtype)
    return out


def _pieces(n: int, p: int, size: int) -> list:
    """[start, stop) of each of the p pieces of an n-long dimension cut in
    pieces of ``size`` (the last ones short or empty)."""
    return [(min(k * size, n), min((k + 1) * size, n)) for k in range(p)]


def _recut(t: torch.Tensor, grid, axis: str, dim: int, src: list,
           dst: list, size: int) -> torch.Tensor:
    """Re-cut dimension ``dim`` of a tensor cut over ``axis``: this rank
    holds H's rows ``src[me] = (s0, s1)`` and gets a ``size``-long piece
    whose runs ``dst[me] = [(H's start, H's stop, offset)]`` come from
    H's rows (zeros elsewhere), the overlaps passed point to point within
    the axis group (no member holds more than its two pieces)."""
    import torch.distributed as dist
    from .mesh import _wire
    me = grid.index(axis)
    s0, s1 = src[me]
    shape = list(t.shape)
    shape[dim] = size
    out = torch.zeros(shape, dtype=t.dtype, device=t.device)
    ops, recvs = [], []
    for k in range(grid.size(axis)):
        peer = None if k == me else grid.global_rank(axis, k)
        for a0, a1, _ in dst[k]:                   # mine, k's rows
            a, b = max(s0, a0), min(s1, a1)
            if b > a and peer is not None:
                piece = t.narrow(dim, a - s0, b - a).contiguous()
                grid.stats.add("sendrecv", piece)
                ops.append(dist.P2POp(dist.isend, _wire(piece), peer,
                                      grid.group(axis)))
        for a0, a1, off in dst[me]:                # k's, my rows
            a, b = max(src[k][0], a0), min(src[k][1], a1)
            if b <= a:
                continue
            if peer is None:
                out.narrow(dim, off + a - a0, b - a).copy_(
                    t.narrow(dim, a - s0, b - a))
                continue
            shape[dim] = b - a
            buf = torch.empty(shape, dtype=t.dtype, device=t.device)
            recvs.append((buf, off + a - a0))
            ops.append(dist.P2POp(dist.irecv, _wire(buf), peer,
                                  grid.group(axis)))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for buf, at in recvs:
        out.narrow(dim, at, buf.shape[dim]).copy_(buf)
    return out


def _sharded_pad(L: torch.Tensor, grid, rows: tuple, cols: tuple,
                 gershgorin: bool = True) -> torch.Tensor:
    """:func:`gershgorin_pad` (or, with ``gershgorin=False``,
    :func:`magnitude_pad`) of the H whose piece [rows) × [cols) this rank
    holds as ``L`` (the grid's (Shard(0), Shard(1)) cut): row sums summed
    over 'c', their maximum over 'r' — the same bits on every rank."""
    import torch.distributed as dist
    a = torch.sum(torch.abs(L), dim=1)
    g0, g1 = max(rows[0], cols[0]), min(rows[1], cols[1])
    if gershgorin and g1 > g0:
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
        self.pseudo_hermitian = bool(pseudo_hermitian)
        dtype = as_torch_dtype(H.dtype)
        real_dtype(dtype)         # TypeError for a dtype the solver lacks
        self._H_low = None
        self.N_orig = int(H.shape[0])
        self.half = None          # (N/2, h_pad) of the S-preserving pad
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
            if isinstance(H, torch.Tensor) and not resident:
                host_sync("operator.to_device")
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
        """This rank's block of H padded to a multiple of r·c (each half
        to one, for a pseudo-Hermitian H)."""
        r, c = self.grid.size("r"), self.grid.size("c")
        tile = r * c
        N = self.N_orig
        if self.pseudo_hermitian:
            h_pad = -(-(N // 2) // tile) * tile
            self._N = 2 * h_pad
            if h_pad != N // 2:
                self.half = (N // 2, h_pad)
        else:
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
        pad = None
        if self._N != N:
            pad = magnitude_pad(H) if self.pseudo_hermitian \
                else gershgorin_pad(H)
        self.H = block_of(H, rows, cols, self._N, dtype=dtype,
                          device=self.device, pad=pad, half=self.half)

    def _sharded_block(self, H, dtype, rows: tuple,
                       cols: tuple) -> torch.Tensor:
        """This rank's block of a DTensor H, never gathered: a ``(Shard(0),
        Shard(1))`` H on the grid's mesh is re-cut from DTensor's even
        split of N_orig to the padded layout point to point
        (:func:`_recut`; H's rows and columns to where the padded layout,
        half-split for a pseudo-Hermitian H, puts them) and padded with
        the diagonal from its pieces' row sums.  ValueError for any other
        layout."""
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
        if Np == N:
            return _padded_block([(L, 0, 0)], rows, cols, [], dtype=dtype,
                                 device=self.device)
        pad = _sharded_pad(L, self.grid, src_r[i], src_c[j],
                           gershgorin=not self.pseudo_hermitian)
        for axis, dim, p, src in (("r", 0, r, src_r), ("c", 1, c, src_c)):
            b = Np // p
            dst = [source_rows(N, self.half, k * b, b) for k in range(p)]
            L = _recut(L, self.grid, axis, dim, src, dst, b)
        return _padded_block([(L, 0, 0)], rows, cols,
                             _phantoms(N, Np, self.half, pad), dtype=dtype,
                             device=self.device)

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
        without a copy.  The first build is the span ``chase.operator``."""
        if self._H_low is None:
            with span("chase.operator"):
                lp = low_precision_dtype(self.dtype)
                if self.device.type == "cuda":
                    self._H_low = padded_empty(self.H.shape[0], lp,
                                               self.device, self.H.shape[1])
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
        N rows; the phantom rows of a padded operator are zero, and H's
        rows go where the pad puts them) or, on a grid, a DTensor
        ``(Shard(0), Replicate())`` as ``eigsh`` returns it (its local
        rows taken where the layouts agree)."""
        if self.grid is None:
            if V.shape[0] != self.N:
                raise ValueError(f"block has {V.shape[0]} rows, operator "
                                 f"N = {self.N}")
            return to_device(V, self.device, self.dtype)
        if V.shape[0] not in (self.N_orig, self.N):
            raise ValueError(f"block has {V.shape[0]} rows, operator N = "
                             f"{self.N_orig} (padded {self.N})")
        r0, n = self.rows
        runs = None
        if _is_dtensor(V):
            # under the half-split pad H's rows never lie as DTensor's
            local = None if self.half else _local_rows_of(V, self.grid, n)
            if local is None:
                V = V.full_tensor()
            else:
                V, runs = local, [(0, n, 0)]
        if runs is None:
            runs = (source_rows(self.N_orig, self.half, r0, n)
                    if V.shape[0] == self.N_orig else [(r0, r0 + n, 0)])
        out = torch.zeros((n, V.shape[1]), dtype=self.dtype,
                          device=self.device)
        for a, b, off in runs:
            part = V[a:min(b, V.shape[0])]
            if not isinstance(part, torch.Tensor):
                part = torch.as_tensor(np.asarray(part))
            out[off:off + part.shape[0]] = part.resolve_conj().resolve_neg()
        return out

    def unpad_block(self, V: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a result multivector without the phantom
        rows of a padded operator (V itself when nothing was padded; a
        new tensor when the S-preserving pad splits them)."""
        if self.N == self.N_orig:
            return V
        runs = source_rows(self.N_orig, self.half, *self.rows)
        if len(runs) <= 1:
            a, b, o = runs[0] if runs else (0, 0, 0)
            return V[o:o + b - a]
        return torch.cat([V[o:o + b - a] for a, b, o in runs])

    def unpad_whole(self, V: torch.Tensor) -> torch.Tensor:
        """The whole (N, k) multivector without its phantom rows: H's
        N_orig rows in H's order."""
        if self.N == self.N_orig:
            return V
        return torch.cat([V[d:d + m] for d, _, m in _row_map(self.N_orig,
                                                             self.half)])


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
