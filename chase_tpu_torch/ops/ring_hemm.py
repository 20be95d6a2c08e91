"""The filter's ring HEMM: ``W (=|+=) H[:, col0:col0+b] · V``.

Port of ``chase_tpu/ops/pallas_ring.py`` (the Pallas RDMA ring kernel,
``_ring_kernel``).  One call is one ring step: ``accumulate=False`` is the
TPU kernel's step-0 store, ``accumulate=True`` its later-step add, so the
multi-GPU ring can feed the V chunks it receives into the same kernel.  On
one card (p = 1) a filter step is a single call with ``col0=0``.

``trans=True`` is the conjugate-transposed A route, ``W (=|+=)
H[col0:col0+b, :]ᴴ · V`` (``col0`` then names the first row of H's
slab): one ring_B step of the 2-D ring, the JAX package's
``_mm(h_blk.conj().T, cur)`` (``chase_tpu/parallel/ring.py``), read from
the rank's block in place.  Every route below has it: the kernel loads
its H tile MN-major, and for c64 the complex pre-pass splits conj(V) and
the kernel negates Im of its product, as Hᴴ·V = conj(Hᵀ·conj(V)).

On a CUDA tensor one call is two launches of ``csrc/ring_hemm.cu`` (built
on first use, see ``_build``): a pre-pass that lays V's chunk out as the
main kernel's B operand, then the main kernel (TMA + wgmma, f32 sums).
Three routes, by H's dtype:

* f32 (H, V, out f32): the pre-pass :func:`tf32_split` writes V's chunk
  transposed and split into TF32 ``hi`` and ``lo`` parts, and the kernel
  multiplies in 3xTF32 (f32-class accuracy on the tensor cores; the error
  scheme is in the source's note).
* complex64 (H, V, out c64) has a kernel of its own that makes the
  complex product of three real 3xTF32 products (the 3M form, as
  ``cublasCgemm3m``): with H = Hr + i·Hi and V = Vr + i·Vi, k1 = (Hr +
  Hi)·Vr, k2 = Hr·(Vi − Vr), k3 = Hi·(Vr + Vi), Re = k1 − k3, Im = k1 +
  k2 — 6·m·b·k FLOPs for a complex product's 8·m·b·k.  The kernel reads
  H's interleaved (re, im) floats and forms Hr + Hi in registers; the
  pre-pass :func:`tf32_split` writes V's chunk as six planes: Vr, Vd =
  fl(Vi − Vr) and Vs = fl(Vr + Vi), each split into TF32 ``hi`` and
  ``lo`` and transposed.  The JAX package reaches its kernel with complex
  data only through a 2N real embedding.
* bf16 (H bf16, V and out f32; the bf16 rung of the precision ladder, as
  the TPU kernel streams a bf16 H): the pre-pass :func:`bf16_pack` rounds
  V's chunk to bf16 and transposes it, and a kernel of its own (128×192 W
  tiles in 2-CTA clusters that share V's tile, both operands of its wgmma
  from shared memory; the source's note) multiplies bf16 · bf16 (exact in
  f32) with f32 sums, promoted into IEEE f32 every 128 deep: ``out (=|+=)
  H.float() @ V.to(bfloat16).float()``.

* :func:`ring_hemm` — the wrapper.  It validates its arguments, then
  launches the kernels for CUDA tensors and raises if a launch fails.
  Only a tensor on the CPU takes the plain version; a CUDA tensor never
  does.  ``LAUNCHES["ring_hemm"]`` counts main-kernel launches (every
  route; ``"ring_hemm:<route> k=<k>"`` by route and width) and nothing
  else; the call is the span ``chase.ring_hemm``, pre-pass included.  H is
  read through TMA: on the card it must be 16-byte
  aligned with a row stride of a whole number of 16 bytes — a multiple of
  4 floats (an even number of complex elements for c64) or of 8 bf16
  elements (``DenseOperator`` allocates it so), or the wrapper raises
  ValueError.  A tensor with torch's lazy conjugate or negative bit
  (``V.conj()``) raises ValueError on every device: the kernel reads
  ``data_ptr()``, which holds the unconjugated data.
* :func:`tf32_split` — the f32 and c64 routes' pre-pass
  (``LAUNCHES["tf32_split"]`` counts both); :func:`bf16_pack` — the bf16
  route's (``LAUNCHES["bf16_pack"]``).
* :func:`ring_hemm_reference`, :func:`tf32_split_reference`,
  :func:`bf16_pack_reference` — the plain PyTorch versions: one
  ``torch.matmul`` with the same accumulate semantics, the TF32 split by
  bit arithmetic, and the rounding by ``.to(torch.bfloat16)``.

The TPU kernel's ring (p > 1), in device code: :func:`ring_hemm_peers`
is one rank's whole (p, 1) ring product ``W = H·V_all``, the JAX
package's ``pallas_ring_hemm`` — its chunk transfer, the RDMA and
barrier of ``_ring_kernel``, moved out of NCCL into ``csrc/
ring_peers.cu``.  On a CUDA tensor: :func:`peer_publish` copies the
rank's chunk into its exported slot (``parallel/peers.PeerChunks``) and
raises the slot's ready flag; :func:`peer_gather` pulls every chunk from
its owner's memory, in ring order, waiting for its flag, and writes it
where it lands as the main kernel's B of the whole V (the split and pack
above, bit for bit); then the main kernel multiplies the whole stripe: one
main launch per product and rank (``LAUNCHES["ring_hemm_peers"]``) where
the chunk ring makes p.  The plain versions: :func:`ring_hemm_peers_reference`
(the ring-ordered sum over the chunks) and :func:`peer_gather_reference`
(each chunk's plain pre-pass at its K rows).
"""

from __future__ import annotations

import ctypes
import functools
import types
from typing import Optional

import torch

from ..perf import COUNTS, count, span

__all__ = ["ring_hemm", "ring_hemm_reference", "tf32_split",
           "tf32_split_reference", "bf16_pack", "bf16_pack_reference",
           "split_shape", "pack_shape", "tma_ld", "tma_row_stride",
           "float_view_args", "load_kernels", "KERNEL_DTYPES",
           "ring_hemm_peers", "ring_hemm_peers_reference", "peer_publish",
           "peer_gather", "peer_gather_reference", "gather_layout",
           "LAUNCHES"]

BK, BN = 32, 128          # csrc/ring_hemm.cu's f32 K tile and W column tile
BK_C64, BN_C64 = 16, 64   # the c64 kernel's (complex elements)
BK_BF16 = 64              # the bf16 route's K tile (64 bf16 = 128 bytes)
BN_BF16 = 192             # its W column tile (RING_HEMM_BF16_BN)
# H dtypes the kernel takes; V and out have H's dtype, f32 for a bf16 H
KERNEL_DTYPES = (torch.float32, torch.complex64, torch.bfloat16)

# Launches of this module's kernels, by wrapper name ("ring_hemm",
# "tf32_split", "bf16_pack", "ring_hemm_peers", "peer_gather",
# "peer_publish"; a name not yet launched reads 0), and the main launches
# by route and width ("ring_hemm:c64 k=3000", "ring_hemm:f32 trans k=750",
# "ring_hemm_peers:bf16 k=1500"): each wrapper adds one where it launches
# its kernel and nowhere else.  The program's counter registry
# (``perf.COUNTS``, counted under its lock), so it also holds the solvers'
# host syncs and QR fallbacks.
LAUNCHES = COUNTS
ROUTES = {torch.float32: "f32", torch.complex64: "c64",
          torch.bfloat16: "bf16"}


def _launched(name: str, H=None, k: int = 0, trans: bool = False) -> None:
    """Count a launch of ``name``; for a main kernel (``H`` given) also
    under its route and width."""
    count(name)
    if H is not None:
        count(f"{name}:{ROUTES[H.dtype]}{' trans' if trans else ''} k={k}")


def _v_dtype(h_dtype) -> torch.dtype:
    """V's and out's dtype for an H of ``h_dtype``."""
    return torch.float32 if h_dtype == torch.bfloat16 else h_dtype


def ring_hemm_reference(H: torch.Tensor, V: torch.Tensor, *, col0: int = 0,
                        out: Optional[torch.Tensor] = None,
                        accumulate: bool = False,
                        trans: bool = False) -> torch.Tensor:
    """Plain version: ``out (=|+=) H[:, col0:col0 + V.shape[0]] @ V``, or
    with ``trans`` ``H[col0:col0 + V.shape[0], :].mH @ V``; for a bf16 H,
    ``H.float() @ V.to(bfloat16).float()`` (the bf16 products are exact in
    f32, the sums f32)."""
    b = V.shape[0]
    Hb = H[col0:col0 + b, :].mH if trans else H[:, col0:col0 + b]
    if H.dtype == torch.bfloat16:
        prod = Hb.float() @ V.to(torch.bfloat16).float()
    else:
        prod = Hb @ V
    if out is None:
        return prod
    if accumulate:
        return out.add_(prod)
    return out.copy_(prod)


def split_shape(b: int, k: int, off: int = 0,
                dtype=torch.float32) -> tuple:
    """(b_pad, w_pad): the pre-pass output's K extent (``off + b`` rounded
    up to the K tile, at least one tile) and column extent (a multiple of
    the W column tile, at least one), for a (b × k) V of ``dtype``: f32
    (32, 128) or c64 (16, 64 complex elements)."""
    bk, bn = (BK_C64, BN_C64) if dtype == torch.complex64 else (BK, BN)
    return bk * max(1, -(-(b + off) // bk)), bn * max(1, -(-k // bn))


def pack_shape(b: int, k: int, off: int = 0) -> tuple:
    """(b_pad, w_pad) of the bf16 pre-pass's (w_pad × b_pad) output: ``off
    + b`` rounded up to the bf16 K tile (at least one), k to the bf16
    route's W column tile (at least one)."""
    return (BK_BF16 * max(1, -(-(b + off) // BK_BF16)),
            BN_BF16 * max(1, -(-k // BN_BF16)))


def _floats(t: torch.Tensor) -> int:
    """Floats per element: 1 for f32, 2 for c64."""
    return t.element_size() // 4


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 → TF32 (10-bit mantissa), nearest with ties away from zero, as
    ``cvt.rna.tf32.f32``: add half an ulp of TF32 to the magnitude bits and
    clear the 13 bits TF32 drops."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split_into(Vt: torch.Tensor, X: torch.Tensor, off: int) -> None:
    """``Vt[0, :k, off:off+b] = hi(Xᵀ)``, ``Vt[1, …] = lo(Xᵀ)``, with hi =
    tf32(x) and lo = tf32(x − hi), for a real (b × k) X."""
    b, k = X.shape
    hi = _tf32_rna(X)
    Vt[0, :k, off:off + b] = hi.T
    Vt[1, :k, off:off + b] = _tf32_rna(X - hi).T


def tf32_split_reference(V: torch.Tensor, off: int = 0,
                         conj: bool = False) -> torch.Tensor:
    """Plain version of the pre-pass: zeros in (planes, w_pad, b_pad)
    (:func:`split_shape`) holding, from column ``off``, the TF32 ``hi``
    and ``lo`` parts of Vᵀ — for f32 ``Vt[0]`` and ``Vt[1]``; for c64 six
    planes, ``Vt[2c]`` and ``Vt[2c + 1]`` those of component c of (Vr, Vd
    = fl(Vi − Vr), Vs = fl(Vr + Vi)), the 3M product's B operands — of
    conj(V) with ``conj`` (the trans route's)."""
    b, k = V.shape
    b_pad, w_pad = split_shape(b, k, off, V.dtype)
    if V.is_complex():
        re, im = V.real, -V.imag if conj else V.imag
        parts = (re, im - re, re + im)
    else:
        parts = (V,)
    Vt = torch.zeros((2 * len(parts), w_pad, b_pad), dtype=torch.float32,
                     device=V.device)
    for c, X in enumerate(parts):
        _split_into(Vt[2 * c:2 * c + 2], X, off)
    return Vt


def _check_resolved(name: str, t: torch.Tensor, what: str):
    """Raise ValueError for a tensor with torch's lazy conjugate or
    negative bit (``V.conj()``, ``X.conj().imag``): it shares its data with
    the unconjugated tensor, and a kernel that reads ``data_ptr()`` would
    compute with that.  Raised on every device, so the CPU tests catch a
    caller that would hand the card such a view."""
    if t.is_conj() or t.is_neg():
        raise ValueError(f"{what} takes no lazy conjugate or negative view; "
                         f"{name} has is_conj()={t.is_conj()}, is_neg()="
                         f"{t.is_neg()} — pass {name}.resolve_conj()"
                         f".resolve_neg()")


def _check(H, V, col0, out, accumulate, trans=False):
    """Raise on anything the kernel does not take: f32 or c64 operands of
    one dtype, or a bf16 H with f32 V and out; 2-D, on one device, unit
    column stride, no lazy conjugate or negative bit; the block inside H
    (H's rows with ``trans``) and out of the product's shape."""
    if H.dtype not in KERNEL_DTYPES:
        raise TypeError(f"ring_hemm takes a float32, complex64 or bfloat16 "
                        f"H; H is {H.dtype}")
    v_dtype = _v_dtype(H.dtype)
    for name, t in (("H", H), ("V", V), ("out", out)):
        if t is None:
            continue
        _check_resolved(name, t, "ring_hemm")
        if t is not H and t.dtype != v_dtype:
            raise TypeError(f"ring_hemm takes V and out of dtype {v_dtype} "
                            f"with an H of {H.dtype}; {name} is {t.dtype}")
        if t.ndim != 2:
            raise ValueError(f"ring_hemm takes 2-D tensors; {name} has shape "
                             f"{tuple(t.shape)}")
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError(f"ring_hemm needs unit column stride; {name} "
                             f"has strides {t.stride()}")
        if t.shape[0] > 1 and t.stride(0) < max(t.shape[1], 1):
            raise ValueError(f"ring_hemm needs row stride >= width; {name} "
                             f"has strides {t.stride()}")
        if t.device != H.device:
            raise ValueError(f"ring_hemm operands must share a device; "
                             f"{name} is on {t.device}, H on {H.device}")
    m, b, k = H.shape[int(trans)], V.shape[0], V.shape[1]
    what = "row" if trans else "column"
    if col0 < 0 or col0 + b > H.shape[1 - int(trans)]:
        raise ValueError(f"{what} block [{col0}, {col0 + b}) outside H's "
                         f"{H.shape[1 - int(trans)]} {what}s")
    if out is None:
        if accumulate:
            raise ValueError("accumulate=True needs out")
    elif tuple(out.shape) != (m, k):
        raise ValueError(f"out has shape {tuple(out.shape)}, expected "
                         f"{(m, k)}")


def tma_ld(n: int, unit_bytes: int = 4) -> int:
    """``n`` rounded up to a whole number of 16 bytes: the smallest row
    stride, in units of ``unit_bytes`` (4: floats, 2: bf16), that TMA can
    describe for rows of ``n`` such units."""
    a = 16 // unit_bytes
    return -(-n // a) * a


def _tma_units(dtype) -> tuple:
    """(units per element, bytes per unit) of the kernel's TMA view of an
    H of ``dtype``: floats for f32 and c64 (two per element), bf16
    elements for bf16."""
    w = 2 if dtype.is_complex else 1
    return w, dtype.itemsize // w


def tma_row_stride(H: torch.Tensor) -> Optional[int]:
    """H's row stride in the units the kernel's TMA loads read (floats —
    those of its float view for c64 — or bf16 elements), or None where TMA
    cannot describe H: it needs a 16-byte-aligned base and a row stride of
    a whole number of 16 bytes (a single row may have any)."""
    w, ub = _tma_units(H.dtype)
    ld = w * H.stride(0) if H.shape[0] > 1 else tma_ld(w * H.shape[1], ub)
    return None if H.data_ptr() % 16 or (ld * ub) % 16 else ld


def float_view_args(H: torch.Tensor, V: torch.Tensor, col0: int,
                    ldw: int, trans: bool = False) -> tuple:
    """What the main kernel is given for ``out (=|+=) H[:, col0:col0+b]
    · V`` (out with row stride ``ldw`` elements): (ldh, col0, off, b, k,
    ldw), the row strides in the kernel's TMA units (floats — two per
    c64 element — or bf16 elements), the rest in elements.  ``off`` =
    col0 mod 16 bytes (4 f32, 2 c64, 8 bf16) is the pre-pass's shift, and
    ldh is None where TMA cannot read H.  With ``trans`` col0 is H's first
    row, passed as it is (TMA's outer coordinate), and off is 0."""
    w, ub = _tma_units(H.dtype)
    off = 0 if trans else col0 % (16 // (w * ub))
    return (tma_row_stride(H), col0, off, V.shape[0], V.shape[1], w * ldw)


def _check_split_input(V: torch.Tensor):
    if V.dtype not in (torch.float32, torch.complex64) or V.ndim != 2:
        raise TypeError(f"tf32_split takes a 2-D float32 or complex64 "
                        f"tensor, got {V.dtype} of shape {tuple(V.shape)}")
    _check_resolved("V", V, "tf32_split")
    if V.shape[1] > 1 and V.stride(1) != 1:
        raise ValueError(f"tf32_split needs unit column stride; V has "
                         f"strides {V.stride()}")


@functools.lru_cache(maxsize=None)
def _lib():
    from .. import _build
    lib = _build.load_library("ring_hemm")
    splits = {}      # (dtype, conj) → the pre-pass
    for key, fn in (((torch.float32, False), lib.ring_hemm_split_f32),
                    ((torch.float32, True), lib.ring_hemm_split_f32),
                    ((torch.complex64, False), lib.ring_hemm_split_c64),
                    ((torch.complex64, True), lib.ring_hemm_split_c64_conj)):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        splits[key] = fn
    pack = lib.ring_hemm_pack_bf16
    pack.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, ctypes.c_void_p]
    pack.restype = ctypes.c_int
    mains = {}       # (H's dtype, trans) → the main kernel
    for key, fn in (((torch.float32, False), lib.ring_hemm_f32),
                    ((torch.complex64, False), lib.ring_hemm_c64),
                    ((torch.bfloat16, False), lib.ring_hemm_bf16),
                    ((torch.float32, True), lib.ring_hemm_f32_t),
                    ((torch.complex64, True), lib.ring_hemm_c64_t),
                    ((torch.bfloat16, True), lib.ring_hemm_bf16_t)):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        mains[key] = fn
    return types.SimpleNamespace(split=splits, pack=pack, main=mains)


@functools.lru_cache(maxsize=None)
def _peer_lib():
    """``csrc/ring_peers.cu``'s entries: the peer memory and the publish
    and gather launches of :func:`ring_hemm_peers`."""
    from .. import _build
    lib = _build.load_library("ring_peers")
    P, I, LL, ULL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                     ctypes.c_ulonglong)
    sig = {"alloc": [I, LL, P], "free": [I, P], "export": [I, P, P],
           "open": [I, P, P], "close": [I, P], "host_alloc": [LL, P, P],
           "host_free": [P],
           "publish": [P, LL, P, LL, I, I, P, I, ULL, ULL, P, I, ULL, P],
           "gather_f32": [P, I, I, I, ULL, P, I, I, I, I, P, ULL, P],
           "gather_c64": [P, I, I, I, ULL, P, I, I, I, I, P, ULL, P],
           "gather_bf16": [P, I, I, I, ULL, P, I, I, I, I, P, ULL, P]}
    fns = {}
    for name, args in sig.items():
        fn = getattr(lib, f"ring_peers_{name}")
        fn.argtypes, fn.restype = args, ctypes.c_int
        fns[name] = fn
    fns["error"] = lib.ring_peers_error
    fns["error"].argtypes, fns["error"].restype = [I], ctypes.c_char_p
    fns["gather"] = {torch.float32: fns["gather_f32"],
                     torch.complex64: fns["gather_c64"],
                     torch.bfloat16: fns["gather_bf16"]}
    return types.SimpleNamespace(**fns)


def load_kernels() -> None:
    """Build the kernels' library if this checkout has not (nvcc, seconds)
    and load it now rather than inside the first call."""
    _lib()


def _raise_on(err: int, what: str):
    if err == 0:
        return
    if err >= 2000:
        why = f"TMA descriptor encoding failed (CUresult {err - 2000})"
    elif err == 1000:
        why = "cuTensorMapEncodeTiled not found in the CUDA driver"
    else:
        why = f"CUDA error {err}"
    raise RuntimeError(f"{what} launch failed: {why}")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def tf32_split(V: torch.Tensor, off: int = 0,
               conj: bool = False) -> torch.Tensor:
    """The pre-pass: V (b, k) → Vt (2, w_pad, b_pad) with Vt[0] the TF32
    ``hi`` part of Vᵀ, Vt[1] the ``lo`` part, starting at column ``off``
    (ring_hemm passes col0 mod 16 bytes, 0–3 for f32, so that H's TMA
    boxes start on 16 bytes), zero-padded (K-major, the layout wgmma takes
    for 32-bit B operands).  For c64 (``off`` 0–1) Vt is (6, w_pad, b_pad):
    the hi and lo planes of Vr, Vd = fl(Vi − Vr) and Vs = fl(Vr + Vi)
    (module note; ``conj``: of conj(V), the trans route's).  CPU tensors
    run :func:`tf32_split_reference`; CUDA tensors launch the kernel."""
    _check_split_input(V)
    per16 = 2 if V.is_complex() else 4
    if not 0 <= off < per16:
        raise ValueError(f"tf32_split offset must be 0..{per16 - 1} for "
                         f"{V.dtype}, got {off}")
    if V.device.type == "cpu":
        return tf32_split_reference(V, off, conj)
    if V.device.type != "cuda":
        raise RuntimeError(f"tf32_split runs on cuda or cpu tensors, not "
                           f"{V.device}")
    b, k = V.shape
    b_pad, w_pad = split_shape(b, k, off, V.dtype)
    Vt = torch.empty((6 if V.is_complex() else 2, w_pad, b_pad),
                     dtype=torch.float32, device=V.device)
    with torch.cuda.device(V.device):
        err = _lib().split[V.dtype, bool(conj)](
            V.data_ptr(), V.stride(0), Vt.data_ptr(), b, k, off, b_pad,
            w_pad, _stream(V.device))
    _raise_on(err, f"tf32_split kernel (b={b}, k={k})")
    _launched("tf32_split")
    return Vt


def bf16_pack_reference(V: torch.Tensor, off: int = 0) -> torch.Tensor:
    """Plain version of the bf16 pre-pass: ``Vb[:k, off:off+b] =
    V.to(bfloat16).T``, zeros elsewhere in (w_pad, b_pad)."""
    b, k = V.shape
    b_pad, w_pad = pack_shape(b, k, off)
    Vb = torch.zeros((w_pad, b_pad), dtype=torch.bfloat16, device=V.device)
    Vb[:k, off:off + b] = V.to(torch.bfloat16).T
    return Vb


def bf16_pack(V: torch.Tensor, off: int = 0) -> torch.Tensor:
    """The bf16 route's pre-pass: V (b, k) f32 → Vb (w_pad, b_pad) bf16,
    V's rows rounded to nearest-even bf16 (as ``.to(torch.bfloat16)``) and
    transposed (K-major, the layout of the f32 route's B), starting at
    column ``off`` (0–7: H's column col0 mod 8, so that H's TMA boxes
    start on 16 bytes), zero-padded to whole 64-deep K tiles and 192-wide
    column tiles (:func:`pack_shape`).  CPU tensors run
    :func:`bf16_pack_reference`; CUDA tensors launch the kernel."""
    if V.dtype != torch.float32 or V.ndim != 2:
        raise TypeError(f"bf16_pack takes a 2-D float32 tensor, got "
                        f"{V.dtype} of shape {tuple(V.shape)}")
    _check_resolved("V", V, "bf16_pack")
    if V.shape[1] > 1 and V.stride(1) != 1:
        raise ValueError(f"bf16_pack needs unit column stride; V has "
                         f"strides {V.stride()}")
    if not 0 <= off < 8:
        raise ValueError(f"bf16_pack offset must be 0..7, got {off}")
    if V.device.type == "cpu":
        return bf16_pack_reference(V, off)
    if V.device.type != "cuda":
        raise RuntimeError(f"bf16_pack runs on cuda or cpu tensors, not "
                           f"{V.device}")
    b, k = V.shape
    b_pad, w_pad = pack_shape(b, k, off)
    Vb = torch.empty((w_pad, b_pad), dtype=torch.bfloat16, device=V.device)
    with torch.cuda.device(V.device):
        err = _lib().pack(V.data_ptr(), V.stride(0), Vb.data_ptr(), b, k, off,
                          b_pad, w_pad, _stream(V.device))
    _raise_on(err, f"bf16_pack kernel (b={b}, k={k})")
    _launched("bf16_pack")
    return Vb


def ring_hemm(H: torch.Tensor, V: torch.Tensor, *, col0: int = 0,
              out: Optional[torch.Tensor] = None,
              accumulate: bool = False, trans: bool = False) -> torch.Tensor:
    """``out (=|+=) H[:, col0:col0+b] · V`` with b = V.shape[0], or with
    ``trans`` ``out (=|+=) H[col0:col0+b, :]ᴴ · V``.

    Args:
      H: (m, n_cols) f32, c64 or bf16 stripe, unit column stride; on the
        card 16-byte aligned with a row stride that is a multiple of 4
        floats (an even number of c64 elements) or of 8 bf16 elements.
      V: (b, k) chunk of H's dtype (f32 for a bf16 H); may be a column
        window of a wider block.
      col0: first H column of the block that multiplies V (first H row of
        the slab with ``trans``).
      out: (m, k) destination of V's dtype — (n_cols, k) with ``trans``
        (a window is fine); allocated with ``torch.empty`` when None.
      accumulate: add into ``out`` instead of overwriting it.
      trans: multiply by the slab's conjugate transpose, read in place.

    CPU tensors run :func:`ring_hemm_reference`; CUDA tensors launch the
    pre-pass and the kernel on the current stream, or raise.  The
    pre-pass's output (2·w_pad·b_pad floats, 6·w_pad·b_pad for c64, or
    w_pad·b_pad bf16) is scratch of this call.
    """
    with span("chase.ring_hemm"):
        _check(H, V, col0, out, accumulate, trans)
        if H.device.type == "cpu":
            return ring_hemm_reference(H, V, col0=col0, out=out,
                                       accumulate=accumulate, trans=trans)
        if H.device.type != "cuda":
            raise RuntimeError(f"ring_hemm runs on cuda or cpu tensors, not "
                               f"{H.device}")
        m = H.shape[int(bool(trans))]
        if out is None:
            out = torch.empty((m, V.shape[1]), dtype=V.dtype,
                              device=H.device)
        ldh, c0, off, b_k, k_k, ldw = float_view_args(H, V, col0,
                                                      out.stride(0), trans)
        if ldh is None:
            raise ValueError(
                f"ring_hemm reads H through TMA, which needs a 16-byte-"
                f"aligned base and a row stride of a whole number of 16 "
                f"bytes (a multiple of 4 floats, of 2 complex64 or of 8 "
                f"bfloat16 elements); H ({H.dtype}) has row stride "
                f"{H.stride(0)} and base address {H.data_ptr():#x} — "
                f"allocate it with a padded row stride (DenseOperator "
                f"does)")
        bf16 = H.dtype == torch.bfloat16
        Vt = bf16_pack(V, off) if bf16 else tf32_split(V, off, conj=trans)
        with torch.cuda.device(H.device):
            err = _lib().main[H.dtype, bool(trans)](
                H.data_ptr(), ldh, c0, Vt.data_ptr(), Vt.shape[-1],
                Vt.shape[-2], out.data_ptr(), ldw, m, k_k, b_k,
                int(bool(accumulate)), _stream(H.device))
        _raise_on(err, f"ring_hemm kernel (m={m}, k={V.shape[1]}, "
                       f"b={V.shape[0]}, col0={col0}, trans={bool(trans)}, "
                       f"{H.dtype})")
        _launched("ring_hemm", H, V.shape[1], bool(trans))
        return out


# -- the (p, 1) ring product on peer memory ---------------------------------

MAXP = 32                   # ranks of a peer ring (csrc/ring_peers.cu)


class _PeersArg(ctypes.Structure):
    """csrc/ring_peers.cu's ``Peers``: each rank's chunk (pointer, row
    stride in floats) and flags block."""
    _fields_ = [("data", ctypes.c_void_p * MAXP),
                ("ld", ctypes.c_longlong * MAXP),
                ("flags", ctypes.c_void_p * MAXP)]


def gather_layout(h_dtype, p: int, b: int, k: int) -> tuple:
    """(b_pad, w_pad, bK) of the gathered B for p chunks of (b × k) and an
    H of ``h_dtype``: the main kernel's B of the whole (p·b × k) V — the
    pre-pass's (planes, w_pad, b_pad) (two planes for f32, six for c64) or
    the bf16 pack's (w_pad, b_pad) — in which chunk ``src`` fills K rows
    ``[src·bK, (src+1)·bK)``, bK = b."""
    if h_dtype == torch.bfloat16:
        return pack_shape(p * b, k) + (b,)
    return split_shape(p * b, k, 0, h_dtype) + (b,)


def peer_gather_reference(chunks, h_dtype) -> torch.Tensor:
    """Plain version of the gather: each chunk's plain pre-pass
    (:func:`tf32_split_reference`, :func:`bf16_pack_reference`) placed at
    its K rows of the whole's B (:func:`gather_layout`), zeros
    elsewhere — bit for bit the pre-pass of the stacked chunks."""
    p, (b, k) = len(chunks), chunks[0].shape
    b_pad, w_pad, bK = gather_layout(h_dtype, p, b, k)
    bf16 = h_dtype == torch.bfloat16
    dev = chunks[0].device
    planes = 6 if h_dtype == torch.complex64 else 2
    B = (torch.zeros((w_pad, b_pad), dtype=torch.bfloat16, device=dev)
         if bf16 else torch.zeros((planes, w_pad, b_pad),
                                  dtype=torch.float32, device=dev))
    for src, c in enumerate(chunks):
        part = bf16_pack_reference(c) if bf16 else tf32_split_reference(c)
        B[..., src * bK:(src + 1) * bK] = part[..., :bK]
    return B


def ring_hemm_peers_reference(H: torch.Tensor, chunks, me: int, *,
                              out: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Plain version of :func:`ring_hemm_peers`: ``W = Σ_s H[:, src·b:
    (src+1)·b] · chunks[src]``, src = (me + s) mod p, in ring order — the
    JAX package's ``pallas_ring_hemm`` on rank ``me`` (each term as
    :func:`ring_hemm_reference`: a bf16 H's chunk rounded to bf16)."""
    p, b = len(chunks), chunks[0].shape[0]
    for s in range(p):
        src = (me + s) % p
        out = ring_hemm_reference(H, chunks[src], col0=src * b, out=out,
                                  accumulate=s > 0)
    return out


def _peers_arg(V: torch.Tensor, peers) -> _PeersArg:
    """The gather's view of product ``peers.product``: this rank's V as
    it lies, every peer's slot (row stride ``slot_row_floats``), every
    rank's flags."""
    if peers.p > MAXP:
        raise ValueError(f"the peer ring takes at most {MAXP} ranks, not "
                         f"{peers.p}")
    from ..parallel.peers import slot_row_floats
    lds = slot_row_floats(V.shape[1], V.dtype)
    arg = _PeersArg()
    for q in range(peers.p):
        mine = q == peers.me
        arg.data[q] = V.data_ptr() if mine else peers.slot_ptr(
            q, peers.product)
        arg.ld[q] = _floats(V) * V.stride(0) if mine else lds
        arg.flags[q] = peers.flags[q]
    return arg


def _check_publish(V: torch.Tensor) -> None:
    """Raise on a chunk the publish kernel does not take: f32 or c64, 2-D,
    unit column stride, no lazy conjugate or negative bit."""
    if V.dtype not in (torch.float32, torch.complex64) or V.ndim != 2:
        raise TypeError(f"peer_publish takes a 2-D float32 or complex64 "
                        f"chunk, got {V.dtype} of shape {tuple(V.shape)}")
    _check_resolved("V", V, "peer_publish")
    if V.shape[1] > 1 and V.stride(1) != 1:
        raise ValueError(f"peer_publish needs unit column stride; V has "
                         f"strides {V.stride()}")


def peer_publish(V: torch.Tensor, peers) -> None:
    """Publish this rank's chunk for product ``peers.product``: copy V (b ×
    k, f32 or c64, any row stride) into its slot (rows packed:
    ``slot_row_floats``) and raise the slot's ready flag, after the slot's
    earlier readers have counted (a launch of ``csrc/ring_peers.cu``;
    collective when the slots must grow).  Raises an earlier product's
    failed wait."""
    _check_publish(V)
    peers.check()
    b, k = V.shape
    peers.reserve(b * k * V.element_size())
    from ..parallel.peers import (reads_before, ready_epoch, slot_of,
                                  slot_row_floats)
    e, fl = peers.product, _floats(V)
    with torch.cuda.device(V.device):
        err = _peer_lib().publish(
            V.data_ptr(), fl * V.stride(0), peers.slot_ptr(peers.me, e),
            slot_row_floats(k, V.dtype), b, fl * k, peers.flags[peers.me],
            slot_of(e), ready_epoch(e), reads_before(e, peers.p),
            peers.err_dev, peers.me, peers.timeout_ns(), _stream(V.device))
    _raise_on(err, f"peer_publish kernel (b={b}, k={k}, product {e})")
    _launched("peer_publish")


def peer_gather(V: torch.Tensor, peers, h_dtype) -> torch.Tensor:
    """Product ``peers.product``'s B: every rank's chunk — this rank's V,
    the peers' slots once their ready flags reach the product's epoch —
    split (f32, c64) or packed (a bf16 ``h_dtype``) into the main
    kernel's B of the whole (:func:`gather_layout`), one launch; the
    peers' slots released as they are read.  Advances the product."""
    b, k = V.shape
    p = peers.p
    b_pad, w_pad, _ = gather_layout(h_dtype, p, b, k)
    bf16 = h_dtype == torch.bfloat16
    planes = 6 if h_dtype == torch.complex64 else 2
    B = torch.empty((w_pad, b_pad) if bf16 else (planes, w_pad, b_pad),
                    dtype=torch.bfloat16 if bf16 else torch.float32,
                    device=V.device)
    from ..parallel.peers import ready_epoch, slot_of
    e = peers.product
    arg = _peers_arg(V, peers)
    with torch.cuda.device(V.device):
        err = _peer_lib().gather[h_dtype](
            ctypes.byref(arg), p, peers.me, slot_of(e), ready_epoch(e),
            B.data_ptr(), b, k, b_pad, w_pad, peers.err_dev,
            peers.timeout_ns(), _stream(V.device))
    _raise_on(err, f"peer_gather kernel (p={p}, b={b}, k={k}, product {e})")
    _launched("peer_gather")
    peers.advance((p - 1) * b * k * V.element_size())
    return B


def _peer_product(H: torch.Tensor, V: torch.Tensor, peers, ldh: int,
                  out: Optional[torch.Tensor]) -> torch.Tensor:
    """The gather and the main kernel over the whole stripe (col0 = 0, K =
    p·b): one main launch."""
    B = peer_gather(V, peers, H.dtype)
    m, k = H.shape[0], V.shape[1]
    if out is None:
        out = torch.empty((m, k), dtype=V.dtype, device=H.device)
    w, _ = _tma_units(H.dtype)
    with torch.cuda.device(H.device):
        err = _lib().main[H.dtype, False](
            H.data_ptr(), ldh, 0, B.data_ptr(), B.shape[-1], B.shape[-2],
            out.data_ptr(), w * out.stride(0), m, k, H.shape[1], 0,
            _stream(H.device))
    _raise_on(err, f"ring_hemm_peers kernel (m={m}, k={k}, N={H.shape[1]}, "
                   f"{H.dtype})")
    _launched("ring_hemm_peers", H, k)
    return out


def ring_hemm_peers(H: torch.Tensor, V: torch.Tensor, peers, *,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (p, 1) ring product ``W = H · V_all`` on rank ``peers.me``: H
    its stripe (m × p·b), V its chunk (b × k), ``peers`` the ring's
    :class:`~chase_tpu_torch.parallel.peers.PeerChunks` — the JAX
    package's ``pallas_ring_hemm`` on one rank.

    CPU tensors run :func:`ring_hemm_peers_reference` on the chunks of an
    object all-gather.  CUDA tensors: publish V (a launch), meet the
    simulated ranks if any (``peers.meet``), then gather every chunk from
    its owner's memory into the main kernel's B (a launch, in ring order)
    and multiply the whole stripe (one main launch, counted by
    ``LAUNCHES["ring_hemm_peers"]``); or raise — a failed wait of an earlier
    product, a mapping that cannot be made (naming ``ring_backend="xla"``,
    the route without the kernel).  H, V and out as for :func:`ring_hemm`
    (``col0`` = 0, ``accumulate`` False); W is allocated when ``out`` is
    None.
    """
    with span("chase.ring_hemm"):
        _check(H, V, 0, out, False)
        if H.shape[1] != peers.p * V.shape[0]:
            raise ValueError(f"ring_hemm_peers: a stripe of {H.shape[1]} "
                             f"columns for {peers.p} chunks of {V.shape[0]} "
                             f"rows")
        if H.device.type == "cpu":
            return ring_hemm_peers_reference(H, peers.chunks(V), peers.me,
                                             out=out)
        if H.device.type != "cuda":
            raise RuntimeError(f"ring_hemm_peers runs on cuda or cpu tensors, "
                               f"not {H.device}")
        ldh = tma_row_stride(H)
        if ldh is None:
            raise ValueError(f"ring_hemm_peers reads H through TMA: H "
                             f"({H.dtype}) has row stride {H.stride(0)} and "
                             f"base {H.data_ptr():#x} (allocate it padded: "
                             f"DenseOperator does)")
        # collective when the slots must grow: before the launches, which a
        # simulation of the ranks may serialise
        peers.reserve(V.shape[0] * V.shape[1] * V.element_size())
        peer_publish(V, peers)
        peers.meet()
        return _peer_product(H, V, peers, ldh, out)
