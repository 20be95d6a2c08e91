"""Independent problems back to back on a process grid: the
configuration's H cut in blocks over the traffic's (r, c) ``shape``, one
process and one card a rank, each solve ``eigsh(H, …, grid=grid)`` with
H a ``(Shard(0), Shard(1))`` DTensor handed over anew (the operator and
its shadow built each solve, as in ``independent``), from one of the
configuration's ``instances`` = K fixed start blocks — instance j's
drawn by a generator seeded from (0, j), alike on every rank.

run.py's process is rank 0 on card 0.  ``setup`` starts ranks 1 …
r·c − 1 as processes of this module (``python -m portbench.traffic.grid
RANK PORT``, the cell's settings on standard input, ``LOCAL_RANK`` = the
rank's card), and every rank joins through ``multihost.init_grid(shape,
"127.0.0.1:PORT", timeout=timeout_s)`` — NCCL on the cards (the traffic's
``backend``), gloo on the CPU —, builds its block of H on its device
(the family's ``block``: no rank holds more than its block), wraps the
blocks as one DTensor and warms up with one solve capped at
``warmup_max_iter`` iterations; a decision broadcast before the block
sets up NCCL's connections on the whole group while the card is empty.
The window runs whole passes over the K instances in lockstep: before
each pass rank 0 decides whether it starts (``--seconds`` not yet
passed) and broadcasts the decision.  Rank 0 times each solve on the
host clock after a device synchronize, reads its peak memory (the ranks
are symmetric; each rank logs its peak allocated and reserved) and
keeps its rows of V's nev columns, as every rank keeps its own;
``release`` frees the blocks, gathers each solve's V to rank 0 and lets
the ranks go; ``judge`` holds each solve to the family's reference
operator on rank 0's device.

A rank that fails or whose process ends early makes run.py exit non-zero
at once (rank 0 watches its ranks; a rank that raises exits 1), and a
rank that hangs makes the group's collectives fail within ``timeout_s``;
ranks 1 … r·c − 1 end with rank 0's process.  Every rank leaves the
process group at the same point, after the last exchange (NCCL's
teardown waits for the whole group).  A rank refuses ``jax``,
``jaxlib``, ``flax`` and ``chase_tpu`` as run.py does."""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import socket
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from portbench import loop
from portbench.seeds import generator

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "chase_tpu")
POLL_S = 0.5            # how often a rank looks at the processes it watches
EXIT_S = 60.0           # how long rank 0 waits for a rank to exit at the end


def log(msg: str) -> None:
    print(f"[portbench grid] {msg}", file=sys.stderr, flush=True)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spec_of(cell) -> dict:
    """What a rank needs of run.py's cell, as JSON."""
    return {"cfg": cell.cfg, "traffic": cell.traffic, "seed": cell.seed,
            "device": cell.device.type, "trace": cell.trace,
            "dtype": str(cell.solve_dtype).split(".")[-1], "tol": cell.tol,
            "config": dataclasses.asdict(cell.chase_config)}


class RankCell:
    """run.py's cell as ranks 1 … r·c − 1 see it, from :func:`spec_of`."""

    def __init__(self, spec: dict, device: torch.device):
        import chase_tpu_torch as ct
        self.ct = ct
        self.cfg, self.traffic = spec["cfg"], spec["traffic"]
        self.family = importlib.import_module(
            f"portbench.matrices.{self.cfg['family']}")
        self.entry = getattr(ct, self.cfg["entry"])
        self.seed, self.trace, self.device = spec["seed"], spec["trace"], \
            device
        self.nev, self.nex = int(self.cfg["nev"]), int(self.cfg["nex"])
        self.solve_dtype = getattr(torch, spec["dtype"])
        self.tol = float(spec["tol"])
        self.chase_config = ct.ChaseConfig(**spec["config"])
        self.problem = None
        self.norm = None

    def make(self) -> None:
        self.problem = self.family.make(self.cfg, int(self.cfg["matrix_seed"]),
                                        self.device)
        self.norm = self.problem.norm

    def note_peak(self) -> None:
        pass


class _Local:
    """What ``loop.Mode.timed`` reads of a grid solve: V is this rank's
    rows."""

    def __init__(self, res):
        self.iterations, self.converged = res.iterations, res.converged
        self.ritzv, self.perf = res.ritzv, res.perf
        self.V = res.V.to_local()


class Mode(loop.Mode):

    def __init__(self, cell, rank: int = 0):
        super().__init__(cell)
        self.rank = rank
        self.shape = tuple(int(x) for x in cell.traffic["shape"])
        self.world = self.shape[0] * self.shape[1]
        self.procs = []
        self.grid = self.H = None
        self.block_bytes = 0
        self.kept = []          # each solve's rows of V's nev columns
        self.done = False

    # -- the group ---------------------------------------------------------

    def _fail(self, msg: str) -> None:
        """Rank 0: end every rank and the process, exit code 1."""
        log(msg)
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()
        os._exit(1)

    def _watch_ranks(self) -> None:
        """Rank 0: a rank's process that ends before ``release`` has let
        the ranks go fails the run at once."""
        def run():
            while not self.done:
                for k, p in enumerate(self.procs, 1):
                    code = p.poll()
                    if code is not None and not self.done:
                        self._fail(f"rank {k} exited with code {code} "
                                   f"before the run's end")
                time.sleep(POLL_S)
        threading.Thread(target=run, daemon=True).start()

    def _spawn(self, port: int) -> None:
        spec = json.dumps(spec_of(self.cell))
        path = os.environ.get("PYTHONPATH")
        for k in range(1, self.world):
            env = dict(os.environ, RANK=str(k), WORLD_SIZE=str(self.world),
                       LOCAL_RANK=str(k),
                       PYTHONPATH=str(ROOT) + (os.pathsep + path if path
                                               else ""))
            p = subprocess.Popen(
                [sys.executable, "-m", "portbench.traffic.grid", str(k),
                 str(port)], cwd=ROOT, env=env, stdin=subprocess.PIPE,
                stdout=2, text=True)
            self.procs.append(p)
            p.stdin.write(spec)
            p.stdin.close()

    def _memory(self) -> None:
        """Log this rank's peak allocated and reserved memory."""
        d = self.cell.device
        if d.type == "cuda":
            log(f"rank {self.rank}: peak allocated "
                f"{torch.cuda.max_memory_allocated(d) / 2**30:.3f} GiB, "
                f"reserved {torch.cuda.max_memory_reserved(d) / 2**30:.3f} "
                f"GiB")

    def _join(self, port: int) -> None:
        c = self.cell
        want = "nccl" if c.device.type == "cuda" else "gloo"
        if c.device.type == "cuda" and c.traffic.get("backend") != want:
            raise ValueError(f"the grid traffic on cards runs {want}, not "
                             f"{c.traffic.get('backend')!r}")
        from chase_tpu_torch.parallel import multihost
        self.grid = multihost.init_grid(
            self.shape, f"127.0.0.1:{port}", device=c.device.type,
            timeout=float(c.traffic["timeout_s"]))

    def _build(self) -> None:
        """This rank's block of H, on its device; H the DTensor of all."""
        from torch.distributed.tensor import DTensor, Shard
        c, g = self.cell, self.grid
        N = int(c.cfg["N"])
        if N % self.world:
            raise ValueError(f"N = {N} is not a multiple of the grid's "
                             f"{self.world} ranks")
        block = c.family.block(c.problem.inputs, g.block(N, "r"),
                               g.block(N, "c"), c.solve_dtype, g.device)
        self.block_bytes = loop.nbytes(block)
        self.H = DTensor.from_local(block, g.mesh, (Shard(0), Shard(1)),
                                    run_check=False, shape=(N, N),
                                    stride=(N, 1))

    def _solve(self, config, g) -> _Local:
        c = self.cell
        return _Local(c.entry(self.H, c.nev, c.nex, tol=c.tol, config=config,
                              grid=self.grid, generator=g,
                              collect_perf=c.trace))

    def _connect(self) -> None:
        """One decision broadcast on the whole group, before any block is
        built.  NCCL sets up a collective's connections at its first call
        (0.7 s for the first broadcast on four H100s) and takes their
        buffers from the card outside the caching allocator, which a
        warmed-up rank has filled to the card's edge: made there, the
        first broadcast fails with CUDA's out-of-memory error inside
        NCCL.  (The gather of V, the group's first sends, follows
        ``release``'s ``empty_cache``.)"""
        self._decide()

    def _warm_up(self) -> None:
        """One solve capped at ``warmup_max_iter`` iterations."""
        c = self.cell
        self._solve(dataclasses.replace(
            c.chase_config, max_iter=int(c.traffic["warmup_max_iter"])),
            generator(self.grid.device, c.seed, "warmup"))

    def _decide(self, go: bool = False) -> bool:
        """Rank 0's decision (whether a pass starts, or whether the ranks
        may go), broadcast to every rank."""
        flag = torch.full((1,), int(go), dtype=torch.int32,
                          device=self.grid.device)
        dist.broadcast(flag, src=0)
        return bool(flag.item())

    def _start(self, j: int):
        c = self.cell
        K = int(c.cfg["instances"])
        return generator(self.grid.device, 0, "start", (c.seed + j) % K)

    def _gather(self) -> list:
        """Each kept V whole on rank 0 (rows sent by grid column 0's
        ranks; None on the other ranks)."""
        mesh = self.grid.mesh.mesh
        i, j = self.grid.coords
        out = []
        for V in self.kept:
            V = V.contiguous()
            if self.rank == 0:
                parts = [V]
                for src in range(1, self.shape[0]):
                    buf = torch.empty_like(V)
                    dist.recv(torch.view_as_real(buf) if buf.is_complex()
                              else buf, src=int(mesh[src][0]))
                    parts.append(buf)
                out.append(torch.cat(parts))
            elif j == 0:
                dist.send(torch.view_as_real(V) if V.is_complex() else V,
                          dst=0)
            del V
        self.kept = []
        return out

    # -- rank 0: run.py's traffic mode --------------------------------------

    def setup(self) -> None:
        port = free_port()
        self._spawn(port)
        self._watch_ranks()
        os.environ.update(RANK="0", WORLD_SIZE=str(self.world),
                          LOCAL_RANK="0")
        self._join(port)
        self._connect()
        self._build()
        self._warm_up()

    def window(self, seconds: float) -> list:
        c = self.cell
        K = int(c.cfg["instances"])
        start = time.perf_counter()
        while self._decide(time.perf_counter() - start < seconds):
            for j in range(K):
                g = self._start(j)
                rec = self.timed(lambda: self._solve(c.chase_config, g),
                                 self.block_bytes)
                if rec.error is not None:
                    self._fail(f"solve {len(self.solves)} raised on rank "
                               f"0:\n{rec.error}")
                self.solves.append(rec)
                self.kept.append(rec.V)
        return self.solves

    def release(self) -> None:
        self._memory()
        self.H = None
        if self.grid.device.type == "cuda":
            torch.cuda.empty_cache()
        for rec, V in zip(self.solves, self._gather()):
            rec.V = V
        self.done = True
        self._decide(False)
        # NCCL's teardown waits for every rank of the group: all leave it
        # together, before rank 0 waits for the ranks' processes
        dist.destroy_process_group()
        for k, p in enumerate(self.procs, 1):
            try:
                p.wait(timeout=EXIT_S)
            except subprocess.TimeoutExpired:
                log(f"rank {k} had not exited {EXIT_S:.0f} s after the "
                    f"group ended: killed")
                p.kill()
                p.wait()

    def judge(self) -> list:
        c = self.cell
        ref = importlib.import_module(
            f"portbench.reference.{c.cfg['family']}")
        exact = ref.exact(c.problem.inputs)
        H = ref.operator(c.problem.inputs, c.device)
        return [self.numbers(H, rec, exact) for rec in self.solves]

    # -- ranks 1 … r·c − 1 ---------------------------------------------------

    def serve(self, port: int) -> None:
        c = self.cell
        self._join(port)
        self._connect()
        self._build()
        self._warm_up()
        while self._decide():
            for j in range(int(c.cfg["instances"])):
                self.kept.append(
                    self._solve(c.chase_config, self._start(j)).V[:, :c.nev])
        self._memory()
        self.H = None
        if self.grid.device.type == "cuda":
            torch.cuda.empty_cache()
        self._gather()
        self._decide()                    # rank 0 lets the ranks go
        dist.destroy_process_group()


def _end_with_parent() -> None:
    """Exit when the process that started this rank has ended."""
    parent = os.getppid()

    def run():
        while os.getppid() == parent:
            time.sleep(POLL_S)
        os._exit(1)
    threading.Thread(target=run, daemon=True).start()


def main(argv: list) -> int:
    rank, port = int(argv[0]), int(argv[1])
    _end_with_parent()
    spec = json.loads(sys.stdin.read())
    if spec["device"] == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    else:
        device = torch.device("cpu")
    cell = RankCell(spec, device)
    cell.make()
    Mode(cell, rank).serve(port)
    found = sorted({n.split(".")[0] for n in list(sys.modules)}
                   & set(FORBIDDEN))
    if found:
        log(f"rank {rank}: forbidden modules loaded: {found}")
        return 3
    return 0


if __name__ == "__main__":
    try:
        code = main(sys.argv[1:])
    except BaseException:
        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
