"""The (p, 1) ring's peer memory: each rank's exported chunk slots and
flags, and its mapping of every peer's.

The counterparts of the Pallas ring kernel's V double buffer, its DMA and
barrier semaphores and its ``collective_id``
(``chase_tpu/ops/pallas_ring.py``), for the peer route of the ring
product (``ops/ring_hemm.ring_hemm_peers``, ``csrc/ring_peers.cu``):

* each rank allocates, in the kernels' library (one ``cudaMalloc`` each,
  so that an IPC handle maps exactly the block), its flags (two ready
  epochs, two read counts) and its two chunk slots, and exports their
  CUDA IPC handles;
* the handles go round the ring's group in an object all-gather; a rank
  opens its peers' (``cudaIpcOpenMemHandle``, peer access enabled
  lazily), and takes a peer's pointer as it is when the peer is a thread
  of its own process (the simulated ranks of ``chip_smoke.py``);
* the slots grow collectively when a wider chunk needs it — widths are
  replicated host decisions, so every rank grows at the same product —
  after every rank has finished its queued work;
* product e uses slot e mod 2: the owner's publish waits until the slot's
  read count reaches (p − 1)·⌊e/2⌋ (every reader of products e − 2, e − 4,
  … has counted), copies its chunk and raises the ready flag to e + 1; a
  reader waits for that epoch and counts once it has read the chunk
  (:func:`slot_of`, :func:`ready_epoch`, :func:`reads_before`).  Epochs
  only grow, so an old flag never passes for a new one.

A wait that passes ``timeout_s`` ends its launch and leaves an error
record in pinned host memory; a gather that gave up writes NaN in place of
the chunk it did not get, so the product comes out NaN.
:meth:`PeerChunks.check` raises a RuntimeError naming the rank, the
product and the peer: every publish calls it, and so do the solvers after
each iteration's host read (``Grid2D.check_peers``).  A mapping that
fails raises a RuntimeError that names ``ring_backend="xla"``, the ring
without the kernel: nothing falls back.

The memory is freed collectively by :meth:`PeerChunks.close` (the grid's
``Grid2D.close``, which ``interface.finalize`` and the CLI call), after
every rank's queued work.  A PeerChunks collected without it frees its own
blocks at once, with no wait for a peer that may still be reading them:
close the grid before dropping it.
"""

from __future__ import annotations

import ctypes
import os
import weakref
from typing import Callable, Optional

import torch

from ..ops.ring_hemm import _peer_lib

__all__ = ["PeerChunks", "slot_of", "ready_epoch", "reads_before",
           "slot_row_floats", "DEFAULT_TIMEOUT_S"]

DEFAULT_TIMEOUT_S = 120.0
FLAGS_BYTES = 4096          # ready[2], reads[2] and the rank's own words
ERR_WORDS = 8               # the error record: code, rank, product, peer,
#                             seen, wanted
SLOT_ALIGN = 2 << 20        # slot capacity rounding (bytes)
NO_XLA = ("the (p, 1) ring's peer route (ring_backend='pallas' on a CUDA "
          "grid) needs CUDA IPC and peer access between the ranks' cards; "
          "ring_backend='xla' runs the ring without the kernel, over NCCL")


def slot_of(e: int) -> int:
    """The slot product ``e`` publishes into and reads from."""
    return e % 2


def ready_epoch(e: int) -> int:
    """The value product ``e``'s publish raises its slot's ready flag to
    (a reader waits for it)."""
    return e + 1


def reads_before(e: int, p: int) -> int:
    """The read count the owner's slot must reach before product ``e``'s
    publish overwrites it: p − 1 readers of each earlier product on the
    slot."""
    return (p - 1) * (e // 2)


def slot_row_floats(k: int, dtype) -> int:
    """The row stride, in floats, of a published chunk of ``k`` columns
    of ``dtype`` (f32 or c64) in its slot: the rows packed, so that a
    contiguous chunk is one range in the slot as in its own memory (the
    publish's flat copy)."""
    return int(k) * (2 if dtype.is_complex else 1)


def _cuda_error(lib, err: int) -> str:
    return f"CUDA error {err} ({lib.error(err).decode()})"


def _release(lib, device: int, own: list, opened: list, host) -> None:
    """Close the peers' mappings and free this rank's blocks (at close()
    or when the object goes; errors ignored: the context may be gone)."""
    for ptr in opened:
        lib.close(device, ptr)
    for ptr in own:
        lib.free(device, ptr)
    if host is not None:
        lib.host_free(host)
    opened.clear()
    own.clear()


class PeerChunks:
    """Rank ``me`` of a p-rank ring's peer memory on ``device``.

    Args:
      me, p: this rank's index and the ring's size.
      device: the rank's card (a CPU device makes a PeerChunks that only
        exchanges chunks in the plain way, :meth:`chunks`).
      allgather: ``allgather(obj) -> list`` of every rank's ``obj`` in
        ring order (``Grid2D.peers``: ``dist.all_gather_object`` over the
        ring's group).
      meet: called between a product's publish and its gather — None in a
        process per rank; a barrier of the simulated ranks of one stream,
        so that every rank's publish is queued before any rank's gather.
      stats: a ``CollectiveStats`` that counts each product's pulled bytes
        under "peer".
      timeout_s: the bound of every wait in the kernels.
    """

    def __init__(self, me: int, p: int, device, allgather: Callable, *,
                 meet: Optional[Callable] = None, stats=None,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        self.me, self.p = int(me), int(p)
        self.device = torch.device(device)
        self._allgather = allgather
        self._meet = meet
        self.stats = stats
        self.timeout_s = float(timeout_s)
        self.product = 0            # e: products done with these peers
        self.capacity = 0           # bytes of each slot
        self.flags = [0] * self.p   # every rank's flags block (this one's)
        self.slots = [0] * self.p   # every rank's slot block
        self._own, self._opened = [], []
        self._host = self._err = None
        self.err_dev = None         # the error record, as the kernels see it
        self._fin = None

    # -- the plain exchange and the simulation's hook -----------------------

    def chunks(self, V: torch.Tensor) -> list:
        """Every rank's chunk, in ring order (an object all-gather: the
        plain version's exchange)."""
        return self._allgather(V)

    def meet(self) -> None:
        if self._meet is not None:
            self._meet()

    # -- mapping ------------------------------------------------------------

    def _index(self) -> int:
        return self.device.index if self.device.index is not None \
            else torch.cuda.current_device()

    def _export(self, lib, nbytes: int) -> dict:
        """A new zeroed block of ``nbytes`` and what a peer needs to map
        it."""
        ptr = ctypes.c_void_p()
        err = lib.alloc(self._index(), nbytes, ctypes.byref(ptr))
        handle = ctypes.create_string_buffer(64)
        if not err:
            self._own.append(ptr.value)
            err = lib.export(self._index(), ptr, handle)
        return dict(pid=os.getpid(), ptr=ptr.value,
                    handle=None if err else handle.raw, err=err)

    def _map(self, lib, nbytes: int) -> list:
        """Collective: a block of ``nbytes`` on every rank, and this
        rank's pointer to each (its own, a peer thread's as it is, another
        process's through IPC).  Every rank raises if any rank failed."""
        mine = self._export(lib, nbytes)
        recs = self._allgather(mine)
        ptrs, why = [], None
        for q, rec in enumerate(recs):
            if rec["handle"] is None:
                why = f"rank {q} could not allocate or export {nbytes} " \
                      f"bytes of peer memory ({_cuda_error(lib, rec['err'])})"
                break
            if q == self.me or rec["pid"] == os.getpid():
                ptrs.append(rec["ptr"])
                continue
            ptr = ctypes.c_void_p()
            err = lib.open(self._index(), rec["handle"], ctypes.byref(ptr))
            if err:
                why = f"rank {self.me} could not map rank {q}'s block " \
                      f"({_cuda_error(lib, err)})"
                break
            self._opened.append(ptr.value)
            ptrs.append(ptr.value)
        whys = [w for w in self._allgather(why) if w is not None]
        if whys:
            raise RuntimeError(f"ring_hemm_peers: {whys[0]}; {NO_XLA}")
        return ptrs

    def reserve(self, nbytes: int) -> None:
        """Collective: flags on first use, and two slots of at least
        ``nbytes`` each (grown after every rank's queued work is done)."""
        if self.device.type != "cuda":
            raise RuntimeError("PeerChunks maps peers' memory on CUDA only")
        if nbytes <= self.capacity:
            return
        lib = _peer_lib()
        with torch.cuda.device(self.device):
            if self._fin is None:
                host, dev = ctypes.c_void_p(), ctypes.c_void_p()
                err = lib.host_alloc(8 * ERR_WORDS, ctypes.byref(host),
                                     ctypes.byref(dev))
                if err:
                    raise RuntimeError(f"ring_hemm_peers: no mapped host "
                                       f"memory: {_cuda_error(lib, err)}")
                self._host, self.err_dev = host.value, dev.value
                self._err = (ctypes.c_longlong * ERR_WORDS).from_address(
                    self._host)
                self._fin = weakref.finalize(
                    self, _release, lib, self._index(), self._own,
                    self._opened, self._host)
                self.flags = self._map(lib, FLAGS_BYTES)
            else:
                # the old slots may still be read by a peer's queued
                # gather: every rank drains its queue, then they meet
                torch.cuda.synchronize(self.device)
                self._allgather(None)
                old = self.slots[self.me]
                for q, ptr in enumerate(self.slots):
                    if q != self.me and ptr in self._opened:
                        self._opened.remove(ptr)
                        lib.close(self._index(), ptr)
                self._own.remove(old)
                lib.free(self._index(), old)
            cap = -(-int(nbytes) // SLOT_ALIGN) * SLOT_ALIGN
            self.slots = self._map(lib, 2 * cap)
            self.capacity = cap

    def slot_ptr(self, q: int, e: int) -> int:
        """Rank q's slot of product ``e``."""
        return self.slots[q] + slot_of(e) * self.capacity

    def slot(self, e: int, shape: tuple, dtype) -> torch.Tensor:
        """This rank's slot of product ``e`` as the published (b, k)
        chunk of ``dtype`` (a view of the peer memory, for checks)."""
        b, k = (int(s) for s in shape)
        row = slot_row_floats(k, dtype) * 4          # bytes
        if b * row > self.capacity:
            raise ValueError("the view is larger than the slot")

        class _View:
            __cuda_array_interface__ = dict(
                shape=(b, k), version=2,
                typestr={torch.float32: "<f4", torch.complex64: "<c8"}[dtype],
                data=(self.slot_ptr(self.me, e), False),
                strides=(row, dtype.itemsize))
        return torch.as_tensor(_View(), device=self.device)

    # -- errors ---------------------------------------------------------------

    def check(self, sync: bool = False) -> None:
        """Raise the first failed wait of this rank's launches (after
        ``torch.cuda.synchronize`` with ``sync``; otherwise those that
        have finished)."""
        if self._err is None:
            return
        if sync:
            torch.cuda.synchronize(self.device)
        code, rank, e, peer, seen, want = list(self._err)[:6]
        if code == 1:
            raise RuntimeError(
                f"ring_hemm_peers (NOT_PUBLISHED): rank {rank} waited "
                f"{self.timeout_s:g} s at product {e} for rank {peer} to "
                f"publish its chunk (its ready flag {seen}, wanted {want})")
        if code == 2:
            raise RuntimeError(
                f"ring_hemm_peers (SLOT_BUSY): rank {rank} waited "
                f"{self.timeout_s:g} s at product {e} for its peers to "
                f"finish reading slot {slot_of(e)} (read count {seen}, "
                f"wanted {want})")
        if code:
            raise RuntimeError(f"ring_hemm_peers: rank {rank} failed with "
                               f"code {code} at product {e}")

    def timeout_ns(self) -> int:
        return int(self.timeout_s * 1e9)

    def advance(self, nbytes: int) -> None:
        """One product done: the next epoch; ``nbytes`` pulled counted."""
        self.product += 1
        if self.stats is not None and self.p > 1:
            self.stats.count("peer", nbytes)

    def close(self) -> None:
        """Collective: free this rank's blocks and close its mappings once
        every rank has finished its queued work (a peer's gather may still
        read this rank's slots until then)."""
        if self._fin is not None and self._fin.alive:
            torch.cuda.synchronize(self.device)
            self._allgather(None)
            self._fin()
        self._fin = self._err = self.err_dev = self._host = None
        self.flags, self.slots = [0] * self.p, [0] * self.p
        self.capacity = self.product = 0
