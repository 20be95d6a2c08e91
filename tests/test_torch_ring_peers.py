"""The (p, 1) ring product on peer memory, ``ring_hemm_peers`` (the TPU
kernel's ring, ``chase_tpu/ops/pallas_ring.py::_ring_kernel``, with its
chunk transfer in ``csrc/ring_peers.cu``), held without a card:

* its plain version, ``ring_hemm_peers_reference``, against the JAX
  package's ``pallas_ring_hemm`` in the TPU interpreter on (2, 1) and
  (3, 1) meshes, f32 and a bf16 H (V bf16-representable: the port's bf16
  route rounds V to bf16, the TPU kernel multiplies it in f32), within
  ``RTOL`` = 1e-5 of the largest entry (f32 sums in another order);
* the gathered B layout: each chunk's plain pre-pass placed at the K rows
  ``gather_layout`` gives it equals the pre-pass of the whole V bit for
  bit — f32, c64 (the six planes of the 3M route), bf16, and a chunk of
  45 rows, which straddles the K tile (32 deep; 16 for c64);
* the publish / read protocol the wrapper passes to the kernels
  (``parallel/peers``: slot, epoch, read count), as a model run by
  hypothesis over p = 2…4 and any interleaving of the ranks: no read
  before its chunk is ready, no slot rewritten before its p − 1 reads, and
  no deadlock;
* the routing: the peer route only on CUDA, with the kernel
  (``ring_backend="pallas"``), a kernel dtype and p > 1;
* the wrapper's CPU path: p threads of one process, each its rank;
* a failed wait's record turned into a RuntimeError naming it
  (``PeerChunks.check``);
* the slot's layout: its row stride (``slot_row_floats``, the rows
  packed), the strides ``_peers_arg`` hands the gather for an odd k, a
  strided V and c64, and the chunks the publish refuses.

The ``gpu``-marked tests at the end run the kernels on one card:

    python -m pytest tests/test_torch_ring_peers.py -m gpu --noconftest
"""

import os
import threading
import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from chase_tpu_torch.ops.ring_hemm import (KERNEL_DTYPES, LAUNCHES,
                                           _peers_arg, bf16_pack_reference,
                                           gather_layout, peer_gather_reference,
                                           peer_publish, ring_hemm_peers,
                                           ring_hemm_peers_reference,
                                           tf32_split_reference)
from chase_tpu_torch.parallel.mesh import CollectiveStats
from chase_tpu_torch.parallel.peers import (PeerChunks, ready_epoch,
                                            reads_before, slot_of,
                                            slot_row_floats)
from chase_tpu_torch.parallel.ring import _product, uses_peers
from chase_tpu_torch.solver import _chunk_product

torch.set_num_threads(1)

RTOL = 1e-5


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    import chase_tpu
    from chase_tpu.ops.pallas_ring import pallas_ring_hemm
    return types.SimpleNamespace(jax=jax, jnp=jnp,
                                 make_grid=chase_tpu.make_grid,
                                 pallas_ring_hemm=pallas_ring_hemm)


def _rel(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def _chunks(V: torch.Tensor, p: int) -> list:
    b = V.shape[0] // p
    return [V[i * b:(i + 1) * b] for i in range(p)]


# -- the plain version against the TPU kernel -----------------------------------

@pytest.mark.parametrize("p,N,k", [(2, 128, 32), (3, 96, 20)],
                         ids=["2x1", "3x1"])
@pytest.mark.parametrize("h", ["f32", "bf16"])
def test_reference_matches_jax_pallas_ring_hemm(jx, p, N, k, h):
    rng = np.random.default_rng(11 + p)
    H = torch.from_numpy(rng.standard_normal((N, N)).astype(np.float32))
    V = torch.from_numpy(rng.standard_normal((N, k)).astype(np.float32))
    if h == "bf16":
        H, V = H.to(torch.bfloat16), V.to(torch.bfloat16).float()
    grid = jx.make_grid(jx.jax.devices()[:p], shape=(p, 1))
    Hj = jx.jnp.asarray(H.float().numpy())
    if h == "bf16":
        Hj = Hj.astype(jx.jnp.bfloat16)
    Hs = jx.jax.device_put(Hj, grid.sharding("r", None))
    Vs = jx.jax.device_put(jx.jnp.asarray(V.numpy()),
                           grid.sharding("r", None))
    Wj = np.asarray(jx.pallas_ring_hemm(grid, Hs, Vs, interpret=True),
                    np.float64)
    b = N // p
    chunks = _chunks(V, p)
    for me in range(p):
        W = ring_hemm_peers_reference(H[me * b:(me + 1) * b], chunks, me)
        assert W.dtype == torch.float32 and tuple(W.shape) == (b, k)
        assert _rel(W.numpy(), Wj[me * b:(me + 1) * b]) <= RTOL


def test_reference_sums_in_ring_order():
    """Rank me's sum starts at its own chunk and adds (me + s) mod p:
    bitwise the chunk ring's order (ring_steps with the plain step)."""
    from chase_tpu_torch.ops.ring_hemm import ring_hemm_reference
    from chase_tpu_torch.parallel.ring import ring_steps
    rng = np.random.default_rng(5)
    p, b, k = 3, 20, 9
    H = torch.from_numpy(rng.standard_normal((b, p * b)).astype(np.float32))
    V = torch.from_numpy(rng.standard_normal((p * b, k)).astype(np.float32))
    chunks = _chunks(V, p)
    for me in range(p):
        held = {"s": 0}

        def exchange(send, recv):
            held["s"] += 1
            recv.copy_(chunks[(me + held["s"]) % p])
            return types.SimpleNamespace(wait=lambda: None)

        ref = ring_steps(H, chunks[me], me=me, p=p, exchange=exchange,
                         step=ring_hemm_reference)
        assert torch.equal(ring_hemm_peers_reference(H, chunks, me), ref)


# -- the gathered B layout --------------------------------------------------------

@pytest.mark.parametrize("dtype,p,b,k", [
    (torch.float32, 2, 64, 37), (torch.float32, 3, 45, 37),
    (torch.complex64, 2, 45, 19), (torch.complex64, 4, 16, 130),
    (torch.bfloat16, 3, 45, 37), (torch.bfloat16, 2, 100, 200)],
    ids=["f32", "f32_straddle", "c64_straddle", "c64_p4", "bf16_straddle",
         "bf16_two_tiles"])
def test_gather_layout_is_the_whole_prepass(dtype, p, b, k):
    rng = np.random.default_rng(b + k)
    v_dtype = torch.float32 if dtype == torch.bfloat16 else dtype
    V = torch.from_numpy(rng.standard_normal((p * b, k)).astype(np.float32))
    if v_dtype.is_complex:
        V = torch.complex(V, torch.from_numpy(
            rng.standard_normal((p * b, k)).astype(np.float32)))
    b_pad, w_pad, bK = gather_layout(dtype, p, b, k)
    assert bK == b
    B = peer_gather_reference(_chunks(V, p), dtype)
    whole = bf16_pack_reference(V) if dtype == torch.bfloat16 \
        else tf32_split_reference(V)
    assert tuple(B.shape[-2:]) == (w_pad, b_pad) == tuple(whole.shape[-2:])
    assert torch.equal(B.view(torch.int16 if dtype == torch.bfloat16
                              else torch.int32),
                       whole.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32))


# -- the protocol ---------------------------------------------------------------

class _Model:
    """p ranks, each running ``products`` products: publish (blocked
    until its slot's read count reaches reads_before), then for each peer
    a read that starts once the peer's ready flag reaches ready_epoch.  A
    read ends — adding one to the peer's read count — at any later
    move, as a launch finishes after the host has queued more work: a
    rank goes on to its next publish once it has started every read.
    ``content[q][slot]`` is the product whose chunk the slot holds."""

    def __init__(self, p: int, products: int):
        self.p, self.n = p, products
        self.ready = [[0, 0] for _ in range(p)]
        self.reads = [[0, 0] for _ in range(p)]
        self.content = [[None, None] for _ in range(p)]
        self.read_by = {}                    # (owner, product) -> readers
        self.state = [dict(e=0, published=False, todo=None, open=set())
                      for _ in range(p)]

    def moves(self, r: int) -> list:
        s = self.state[r]
        out = [("end",) + qe for qe in sorted(s["open"])]
        if s["e"] >= self.n:
            return out
        e, slot = s["e"], slot_of(s["e"])
        if not s["published"]:
            if self.reads[r][slot] >= reads_before(e, self.p):
                out.append(("publish",))
            return out
        return out + [("start", q) for q in sorted(s["todo"])
                      if self.ready[q][slot] >= ready_epoch(e)]

    def apply(self, r: int, move: tuple) -> None:
        s = self.state[r]
        e, slot = s["e"], slot_of(s["e"])
        if move[0] == "publish":
            old = self.content[r][slot]
            if old is not None:          # no rewrite before p − 1 reads
                assert self.read_by.get((r, old), 0) == self.p - 1
            self.content[r][slot] = e
            self.ready[r][slot] = ready_epoch(e)
            s["published"], s["todo"] = True, {
                q for q in range(self.p) if q != r}
        elif move[0] == "start":
            q = move[1]
            assert self.content[q][slot] == e    # no read before ready
            s["todo"].remove(q)
            s["open"].add((q, e))
        else:
            q, e_read = move[1], move[2]
            # not rewritten while it was read
            assert self.content[q][slot_of(e_read)] == e_read
            s["open"].remove((q, e_read))
            self.read_by[(q, e_read)] = self.read_by.get((q, e_read), 0) + 1
            self.reads[q][slot_of(e_read)] += 1
        if s["published"] and not s["todo"]:
            s.update(e=e + 1, published=False, todo=None)


@settings(max_examples=150, deadline=None, derandomize=True)
@given(p=st.integers(2, 4), products=st.integers(1, 6),
       choices=st.lists(st.integers(0, 10 ** 6), min_size=400,
                        max_size=400))
def test_protocol_model_any_interleaving(p, products, choices):
    m = _Model(p, products)
    for c in choices * 4:
        options = [(r, mv) for r in range(p) for mv in m.moves(r)]
        if not options:
            break
        m.apply(*options[c % len(options)])
    assert all(s["e"] == products and not s["open"] for s in m.state), \
        "deadlock"
    for q in range(p):
        for e in range(products):
            assert m.read_by[(q, e)] == p - 1


def test_protocol_numbers():
    assert [slot_of(e) for e in range(5)] == [0, 1, 0, 1, 0]
    assert [ready_epoch(e) for e in range(3)] == [1, 2, 3]
    assert [reads_before(e, 4) for e in range(6)] == [0, 0, 3, 3, 6, 6]


# -- the routing ------------------------------------------------------------------

@pytest.mark.parametrize("device,backend,dtype,p,want", [
    ("cuda", "pallas", torch.float32, 2, True),
    ("cuda", "pallas", torch.complex64, 4, True),
    ("cuda", "pallas", torch.bfloat16, 3, True),
    ("cpu", "pallas", torch.float32, 2, False),
    ("cuda", "xla", torch.float32, 2, False),
    ("cuda", "pallas", torch.float64, 2, False),
    ("cuda", "pallas", torch.float32, 1, False)],
    ids=["f32", "c64", "bf16", "cpu", "xla", "f64", "p1"])
def test_routing(device, backend, dtype, p, want):
    ring, kernel = _chunk_product("1d", backend, dtype)
    assert ring
    assert uses_peers(device, kernel, dtype, p) is want


class _CpuGrid:
    """A (2, 1) CPU grid stand-in whose peers() must not be reached."""
    shape = {"r": 2, "c": 1}

    def size(self, axis):
        return self.shape[axis]

    def index(self, axis):
        return 0

    def exchange(self, axis="r"):
        return lambda send, recv: None

    def peers(self, axis="r"):
        raise AssertionError("the CPU takes the chunk ring")


def test_cpu_grid_keeps_the_chunk_ring(monkeypatch):
    import chase_tpu_torch.parallel.ring as ring
    calls = []
    monkeypatch.setattr(ring, "ring_steps",
                        lambda *a, **k: calls.append(k) or "chunk ring")
    H = torch.zeros((4, 8))
    assert _product(H, _CpuGrid(), True)(torch.zeros((4, 3))) == "chunk ring"
    assert calls and calls[0]["step"] is None and calls[0]["p"] == 2


# -- the wrapper on the CPU: p threads, one rank each -----------------------------

def _thread_ranks(p: int, fn, device="cpu", timeout_s=None) -> list:
    """fn(peers) for p PeerChunks of one process, one thread each (their
    all-gather a board between two barriers), each closed by its thread
    afterwards (collectively); results in rank order."""
    board, barrier = [None] * p, threading.Barrier(p, timeout=120)
    out, errors = [None] * p, []

    def allgather(me):
        def run(obj):
            board[me] = obj
            barrier.wait()
            got = list(board)
            barrier.wait()
            return got
        return run

    kw = {} if timeout_s is None else dict(timeout_s=timeout_s)
    peers = [PeerChunks(me, p, device, allgather(me), meet=barrier.wait,
                        stats=CollectiveStats(), **kw) for me in range(p)]

    def rank(me):
        try:
            out[me] = fn(peers[me])
            peers[me].close()
        except BaseException as e:              # noqa: BLE001
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=rank, args=(i,)) for i in range(p)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


@pytest.mark.parametrize("p", [2, 3])
def test_cpu_wrapper_is_the_plain_version(p):
    rng = np.random.default_rng(p)
    b, k = 16, 7
    H = torch.from_numpy(rng.standard_normal((p * b, p * b))
                         .astype(np.float32))
    V = torch.from_numpy(rng.standard_normal((p * b, k)).astype(np.float32))
    chunks = _chunks(V, p)
    before = LAUNCHES["ring_hemm_peers"]
    W = _thread_ranks(p, lambda pc: ring_hemm_peers(
        H[pc.me * b:(pc.me + 1) * b], chunks[pc.me], pc))
    assert LAUNCHES["ring_hemm_peers"] == before
    for me in range(p):
        ref = ring_hemm_peers_reference(H[me * b:(me + 1) * b], chunks, me)
        assert torch.equal(W[me], ref)
    dense = H.double() @ V.double()
    assert _rel(torch.cat(W).numpy(), dense.numpy()) <= RTOL


def test_wrapper_refuses_a_stripe_of_other_width():
    pc = PeerChunks(0, 2, "cpu", lambda obj: [obj, obj])
    with pytest.raises(ValueError, match="stripe"):
        ring_hemm_peers(torch.zeros((4, 12)), torch.zeros((4, 3)), pc)


@pytest.mark.parametrize("record,match", [
    ((1, 0, 3, 1, 0, 4), "rank 0 waited 2 s at product 3 for rank 1 to "
                         "publish its chunk \\(its ready flag 0, wanted 4\\)"),
    ((2, 1, 5, -1, 2, 3), "rank 1 waited 2 s at product 5 for its peers to "
                          "finish reading slot 1 \\(read count 2, wanted 3\\)"),
])
def test_check_names_a_failed_wait(record, match):
    """The kernels' error record (code, rank, product, peer, seen, wanted)
    becomes a RuntimeError naming them; an empty record raises nothing."""
    pc = PeerChunks(0, 2, "cpu", lambda obj: [obj, obj], timeout_s=2.0)
    pc._err = [0] * 8
    pc.check()
    pc._err = list(record) + [0, 0]
    with pytest.raises(RuntimeError, match=match):
        pc.check()


def test_stats_count_peer_bytes():
    s = CollectiveStats()
    s.count("peer", 1200)
    s.add("sendrecv", torch.zeros(5))
    assert s.summary() == {"peer": (1, 1200), "sendrecv": (1, 20)}


@pytest.mark.parametrize("k,dtype,want", [
    (3000, torch.float32, 3000), (2999, torch.float32, 2999),
    (2999, torch.complex64, 5998)], ids=["f32", "f32_odd", "c64_odd"])
def test_slot_row_floats(k, dtype, want):
    """The slot's rows are packed: a contiguous chunk is one range."""
    assert slot_row_floats(k, dtype) == want


def _layout(case: str) -> torch.Tensor:
    """A (5, 7) chunk: contiguous, or a column window of a wider V."""
    dtype = torch.complex64 if case.startswith("c64") else torch.float32
    if case.endswith("window"):
        return torch.zeros((5, 11), dtype=dtype)[:, 3:10]
    return torch.zeros((5, 7), dtype=dtype)


@pytest.mark.parametrize("case", ["f32_odd", "f32_window", "c64_odd",
                                  "c64_window"])
def test_peers_arg_strides(case):
    """The gather reads this rank's V at its own row stride and every
    peer's slot at ``slot_row_floats`` (floats: 2 a c64 element)."""
    V = _layout(case)
    fl = 2 if V.is_complex() else 1
    peers = types.SimpleNamespace(
        p=3, me=1, product=5, flags=[101, 102, 103],
        slot_ptr=lambda q, e: 1000 * q + slot_of(e))
    arg = _peers_arg(V, peers)
    assert arg.data[1] == V.data_ptr() and arg.ld[1] == fl * V.stride(0)
    assert arg.ld[1] == fl * (11 if case.endswith("window") else 7)
    for q in (0, 2):
        assert arg.data[q] == 1000 * q + 1
        assert arg.ld[q] == slot_row_floats(7, V.dtype) == fl * 7
    assert list(arg.flags)[:3] == [101, 102, 103]


@pytest.mark.parametrize("V,error", [
    (torch.zeros((4, 6))[:, ::2], ValueError),
    (torch.zeros((4, 3), dtype=torch.float64), TypeError),
    (torch.zeros((4, 3), dtype=torch.complex64).conj(), ValueError)],
    ids=["column_stride", "f64", "lazy_conj"])
def test_publish_refuses_a_layout_it_does_not_take(V, error):
    """Raised before any peer memory is touched, on every device."""
    pc = PeerChunks(0, 2, "cpu", lambda obj: [obj, obj])
    with pytest.raises(error):
        peer_publish(V, pc)
    assert pc.capacity == 0


def test_kernel_dtypes_have_a_layout():
    for dtype in KERNEL_DTYPES:
        b_pad, w_pad, bK = gather_layout(dtype, 2, 30, 5)
        tile = 16 if dtype == torch.complex64 else 32
        assert b_pad >= 2 * bK and b_pad % tile == 0 and w_pad % 32 == 0


# -- on the card ------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64,
                                   torch.bfloat16], ids=["f32", "c64",
                                                         "bf16"])
def test_cuda_product_of_thread_ranks(cuda, dtype):
    """p = 3 ranks as threads of one process on one card: two products
    each (both slots), the gathered B bit for bit the plain gather, W
    within RTOL of the plain version; one main launch per product and
    rank."""
    from chase_tpu_torch.ops import ring_hemm as rh
    from chase_tpu_torch.parallel.operator import padded_empty
    p, b, k = 3, 333, 70
    g = torch.Generator(device=cuda).manual_seed(3)
    v_dtype = torch.float32 if dtype == torch.bfloat16 else dtype
    H = padded_empty(p * b, dtype, cuda)
    H.copy_(torch.randn((p * b, p * b), generator=g, device=cuda,
                        dtype=v_dtype).to(dtype))
    for rep in range(2):
        V = torch.randn((p * b, k), generator=g, device=cuda, dtype=v_dtype)
        chunks = _chunks(V, p)
        before = rh.LAUNCHES["ring_hemm_peers"]

        def product(pc):
            pc.reserve(b * k * chunks[0].element_size())      # collective
            rh.peer_publish(chunks[pc.me], pc)
            pc.meet()
            B = rh.peer_gather(chunks[pc.me], pc, dtype)
            torch.cuda.synchronize()
            pc.check()
            return B

        Bs = _thread_ranks(p, product, device=cuda)
        plain = peer_gather_reference(chunks, dtype)
        for B in Bs:
            assert torch.equal(B, plain)
        W = _thread_ranks(p, lambda pc: ring_hemm_peers(
            H[pc.me * b:(pc.me + 1) * b], chunks[pc.me], pc), device=cuda)
        assert rh.LAUNCHES["ring_hemm_peers"] == before + p
        for me in range(p):
            ref = ring_hemm_peers_reference(H[me * b:(me + 1) * b], chunks,
                                            me)
            assert _rel(W[me].cpu(), ref.cpu().numpy()) <= RTOL


@pytest.mark.gpu
def test_cuda_product_without_a_mapping_raises(cuda):
    """A peer of another process whose handle does not map: RuntimeError
    naming ring_backend='xla', no fallback."""
    from chase_tpu_torch.parallel.operator import padded_empty

    def allgather(obj):
        if obj is None or not isinstance(obj, dict):
            return [obj, None if obj is None else obj]
        fake = dict(obj, pid=os.getpid() + 1, handle=b"\0" * 64)
        return [obj, fake]

    pc = PeerChunks(0, 2, cuda, allgather)
    H = padded_empty(64, torch.float32, cuda)[:32]
    H.zero_()
    with pytest.raises(RuntimeError, match="ring_backend='xla'"):
        ring_hemm_peers(H, torch.zeros((32, 4), device=cuda), pc)


@pytest.mark.gpu
def test_cuda_missing_publish_raises(cuda):
    """Rank 1 of 2 never publishes: rank 0's product gives up after its
    bound and comes out NaN (the missing chunk's part of its B poisoned),
    and the next check names the rank, the product and the peer."""
    from chase_tpu_torch.parallel.operator import padded_empty
    V = torch.ones((64, 8), device=cuda)
    H = padded_empty(128, torch.float32, cuda)[:64]
    H.fill_(1.0)

    def run(pc):
        if pc.me == 1:
            pc.reserve(V.numel() * 4)       # collective, as rank 0's is
            pc.meet()
            return True
        W = ring_hemm_peers(H, V, pc)
        with pytest.raises(RuntimeError, match="rank 0 waited .* rank 1"):
            pc.check(sync=True)
        return not bool(torch.isfinite(W).any())

    assert all(_thread_ranks(2, run, device=cuda, timeout_s=0.5))


def _slot_bits(pc, e, V) -> torch.Tensor:
    return pc.slot(e, tuple(V.shape), V.dtype).view(torch.int32).clone()


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["f32_odd", "f32_window", "c64_odd",
                                  "c64_window"])
def test_cuda_publish_layouts_bitwise(cuda, case):
    """p = 2 ranks as threads on one card, each chunk (b, k) = (301, 2999)
    contiguous (the publish's flat range at an odd width) or a column
    window V[:, 1:3000] of a (301, 3001) buffer (its row path, the source
    off the slot's 16-byte alignment), f32 and c64: every slot bitwise
    the chunk, the gathered B bitwise the plain gather."""
    from chase_tpu_torch.ops import ring_hemm as rh
    p, b = 2, 301
    dtype = torch.complex64 if case.startswith("c64") else torch.float32
    g = torch.Generator(device=cuda).manual_seed(7)
    if case.endswith("window"):
        V = torch.randn((p * b, 3001), generator=g, device=cuda,
                        dtype=dtype)[:, 1:3000]
    else:
        V = torch.randn((p * b, 2999), generator=g, device=cuda, dtype=dtype)
    chunks = _chunks(V, p)

    def product(pc):
        pc.reserve(b * 2999 * V.element_size())             # collective
        rh.peer_publish(chunks[pc.me], pc)
        pc.meet()
        B = rh.peer_gather(chunks[pc.me], pc, dtype)
        torch.cuda.synchronize()
        pc.check()
        return B, _slot_bits(pc, pc.product - 1, chunks[pc.me])

    plain = peer_gather_reference(chunks, dtype)
    for me, (B, slot) in enumerate(_thread_ranks(p, product, device=cuda)):
        assert torch.equal(slot, chunks[me].view(torch.int32))
        assert torch.equal(B.view(torch.int32), plain.view(torch.int32))


@pytest.mark.gpu
def test_cuda_busy_slot_raises(cuda):
    """Rank 0 of 2 publishes product 0 into slot 0, then, two products on,
    product 2 into the same slot while rank 1 has never read the first:
    the publish gives up after its bound and the check names SLOT_BUSY;
    the slot still holds product 0's chunk, bit for bit."""
    from chase_tpu_torch.ops import ring_hemm as rh
    A = torch.arange(64 * 8, dtype=torch.float32, device=cuda).view(64, 8)
    C = -A - 1

    def run(pc):
        pc.reserve(A.numel() * 4)           # collective
        if pc.me == 1:
            return True
        rh.peer_publish(A, pc)
        pc.product = 2
        rh.peer_publish(C, pc)
        with pytest.raises(RuntimeError, match="SLOT_BUSY.*rank 0 waited "
                                               ".* slot 0"):
            pc.check(sync=True)
        return torch.equal(_slot_bits(pc, 0, A), A.view(torch.int32))

    assert all(_thread_ranks(2, run, device=cuda, timeout_s=0.5))
