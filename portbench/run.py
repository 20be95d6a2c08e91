#!/usr/bin/env python3
"""Run one cell of the chase_tpu_torch benchmark once.

    python3 portbench/run.py --workload <config>.<traffic> --seed <n>
        --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The cell is looked up in ``BENCHMARK.json``; its configuration,
traffic and its generator, matrix family, judge and metric readers are
found by name under ``portbench/``.  Set-up (process start, the port's
kernels built or loaded, the matrix made on the card from the
configuration's matrix seed, warm-up) is timed as ``setup_s``; then the
traffic runs for at least ``--seconds`` (``traffic/<mode>.py``).  With
``--trace 1`` the window runs under torch.profiler with the port's phase
timers on and the readers' instrumentation in place, and the per-layer
metrics are read from them; with
``--trace 0`` the end-to-end ones.  Once the window has closed the plain
reference (``reference/``) judges every timed solve's eigenpairs against
the configuration's limits, which decides ``correct``.  The last line of
standard output is one JSON object; the numbers compared, each beside its
limit, are the last lines of standard error and the result's last key.

Exits non-zero, printing no result, without the cards the cell asks for,
without the port, or when ``jax``, ``jaxlib``, ``flax`` or ``chase_tpu``
was imported.  ``--device cpu`` (tests only) runs a tiny cell on the CPU;
``--variant control`` runs the configuration's lower-precision control in
the program's place.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the checkout's root, not portbench/, heads the import path: the program
# and the package ``portbench`` import from there, and no file here can
# shadow a module of the standard library
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "chase_tpu")

import torch  # noqa: E402

from portbench import devtrace  # noqa: E402
from portbench.seeds import sub_seed  # noqa: E402


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name, compared
    whole, is one the benchmark may not load."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_file_module(path: Path, name: str):
    """The module at ``path`` (a metric reader, whose name may hold
    dots): ``read(run)``, and optionally ``RANGES`` (the
    ``record_function`` ranges whose device time the trace's summary
    should sum) and ``instrument(notes)`` (a context manager around the
    window that records into the list ``notes``, ``run.notes[name]``)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_names(bench: dict, workload: str, trace: bool) -> list:
    """The metrics a run of ``workload`` reports: the end-to-end ones with
    ``--trace 0``, the per-layer ones with ``--trace 1``, each limited to
    its ``workloads`` where it has them."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [(m["name"], m["unit"]) for m in group
            if workload in m.get("workloads", [workload])]


class Cell:
    """One cell as this run sees it: the configuration (its matrix
    ``family``, the port's ``entry`` point, its ``judge``), the traffic,
    the matrix and the entry point it calls."""

    def __init__(self, bench: dict, workload: str, seed: int, device,
                 variant: str, trace: bool):
        import chase_tpu_torch as ct
        self.ct = ct
        entry = next(w for w in bench["workloads"] if w["name"] == workload)
        conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
        self.cfg = load_json(ROOT / conf["file"])
        self.traffic = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
        self.family = importlib.import_module(
            f"portbench.matrices.{self.cfg['family']}")
        self.entry = getattr(ct, self.cfg["entry"])
        self.seed, self.device, self.trace = seed, device, trace
        self.nev, self.nex = int(self.cfg["nev"]), int(self.cfg["nex"])
        self.limits = self.cfg["limits"]
        run = self.cfg if variant == "program" else self.cfg["control"]
        self.solve_dtype = getattr(torch, run["dtype"])
        self.tol = float(run["tol"])
        # the solver's own draws (a sequence's start block and probes):
        # one stream for every run, as the matrix
        self.chase_config = ct.ChaseConfig(
            **run["chase_config"],
            seed=sub_seed(int(self.cfg["matrix_seed"]), "chase"))
        self.problem = None
        self.mem_peak = 0

    def make_matrix(self):
        """The configuration's matrix, drawn from the configuration's
        ``matrix_seed`` (one H for every run: the run's seed orders the
        work and draws what the traffic adds)."""
        return self.family.make(self.cfg, int(self.cfg["matrix_seed"]),
                                self.device)

    def make(self) -> None:
        self.problem = self.make_matrix()
        self.norm = self.problem.norm

    def call(self, H, config, generator):
        return self.entry(
            H, self.nev, self.nex, tol=self.tol, config=config,
            device=self.device, generator=generator,
            collect_perf=self.trace)

    def sequence(self, members):
        return self.ct.eigsh_sequence(
            members, self.nev, self.nex, tol=self.tol,
            config=self.chase_config, device=self.device,
            collect_perf=self.trace)

    def note_peak(self) -> None:
        if self.device.type == "cuda":
            self.mem_peak = max(self.mem_peak,
                                torch.cuda.max_memory_allocated(self.device))


@contextlib.contextmanager
def traced(enabled: bool, device, ranges: tuple):
    """torch.profiler over the block (CPU and, on a card, CUDA
    activities); yields a dict that holds the trace's summary
    (``devtrace.summarize``, with the device time inside ``ranges``)
    after the block."""
    out = {}
    if not enabled:
        yield out
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield out
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        out.update(devtrace.summarize(devtrace.load(path), ranges))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def card(device) -> dict:
    """The card's name and power limit (nvidia-smi), or the CPU's."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit_w": None}
    limit = None
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={torch.cuda.current_device()}",
             "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30).stdout.strip()
        limit = float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        pass
    return {"name": torch.cuda.get_device_name(device), "power_limit_w": limit}


@dataclasses.dataclass
class RunData:
    """What the metric readers (``metrics/<name>.py``: ``read(run)`` →
    a number, or None where there is nothing to read) see."""
    workload: str
    setup_s: float
    window_s: float
    solves: list            # loop.Solve, in the order they ran
    trace: dict             # devtrace.summarize's, {} without a trace
    notes: dict             # what each reader's ``instrument`` recorded
    card: dict


def judged(numbers: list, limits: dict) -> tuple:
    """(checks, failed solves): the largest value of each number over the
    solves beside its limit, and how many solves raised or read past a
    limit (a NaN reads past every limit)."""
    checks, failed = {}, 0
    for nums in numbers:
        if nums is None:
            failed += 1
            continue
        bad = False
        for name, value in nums.items():
            limit = float(limits[name])
            bad |= not value <= limit
            prev = checks.get(name, {}).get("value")
            if prev is None or not value <= prev:
                checks[name] = {"value": value, "limit": limit}
        failed += bad
    return checks, failed


def _json_number(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else str(x)


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--variant", default="program",
                   choices=("program", "control"))
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    chips = int(cells[args.workload]["chips"])
    if args.device == "cuda":
        if not torch.cuda.is_available():
            log("no CUDA card: torch.cuda.is_available() is False")
            return 1
        if torch.cuda.device_count() < chips:
            log(f"the cell needs {chips} cards, {torch.cuda.device_count()} "
                f"visible")
            return 1
    device = torch.device(args.device)
    # the port builds its kernels into <checkout>/build/; anything else a
    # library caches goes inside the checkout as well, at fixed paths
    cache = ROOT / "build" / "portbench-cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    try:
        cell = Cell(bench, args.workload, args.seed, device, args.variant,
                    bool(args.trace))
    except ImportError as e:
        log(f"the program cannot be imported: {e}")
        return 1
    mode = importlib.import_module(
        f"portbench.traffic.{cell.traffic['mode']}").Mode(cell)
    readers = {name: (unit, load_file_module(HERE / "metrics" / f"{name}.py",
                                             f"portbench.metrics.{name}"))
               for name, unit in metric_names(bench, args.workload,
                                              bool(args.trace))}

    # -- set-up -------------------------------------------------------------
    t_make = time.perf_counter()
    cell.make()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_warm = time.perf_counter()
    mode.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    cell.note_peak()
    setup_s = time.perf_counter() - T_START
    log(f"{args.workload} ({args.variant}) seed {args.seed}: set-up "
        f"{setup_s:.3f} s (imports and kernels {t_make - T_START:.3f}, "
        f"matrix {t_warm - t_make:.3f}, warm-up "
        f"{setup_s - (t_warm - T_START):.3f})")

    # -- the window -----------------------------------------------------------
    ranges = tuple(r for _, mod in readers.values()
                   for r in getattr(mod, "RANGES", ()))
    notes = {name: [] for name, (_, mod) in readers.items()
             if hasattr(mod, "instrument")}
    with traced(bool(args.trace), device, ranges) as trace, \
            contextlib.ExitStack() as stack:
        for name in notes:
            stack.enter_context(readers[name][1].instrument(notes[name]))
        with torch.profiler.record_function(devtrace.WINDOW):
            t0 = time.perf_counter()
            solves = mode.window(args.seconds)
            window_s = time.perf_counter() - t0
    cell.note_peak()
    for i, s in enumerate(solves):
        log(f"solve {i}: {s.t1 - s.t0:.4f} s, {s.iterations} iterations, "
            f"converged={s.converged}"
            + (f", adds {s.mem_added / 2**30:.3f} GiB" if s.mem_added else "")
            + (f"; RAISED:\n{s.error}" if s.error else ""))

    if args.trace:
        for name, got in trace.get("annotated", {}).items():
            log(f"{name}: {got['ranges']} traced ranges, {got['device_s']} "
                f"device s")
        log(f"trace busy {trace.get('busy_s')} s of "
            f"{trace.get('window_s')} s")

    # -- the reference ----------------------------------------------------------
    mode.release()
    checks, failed = judged(mode.judge(), cell.limits)
    correct = bool(solves) and failed == 0

    # -- the result -------------------------------------------------------------
    run = RunData(args.workload, setup_s, window_s, solves, trace, notes,
                  card(device))
    metrics = {}
    for name, (unit, reader) in readers.items():
        value = reader.read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded in this process: {found}")
        return 3
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": run.card["name"], "count": chips,
           "memory_peak_bytes": cell.mem_peak}
    if args.trace:
        dev.update(busy_s=trace.get("busy_s", 0.0),
                   window_s=trace.get("window_s", window_s))
    result = {"correct": correct, "attempted": len(solves), "failed": failed,
              "metrics": metrics, "device": dev}
    if args.trace and trace:
        result["breakdown"] = {"device_ops": trace["device_ops"],
                               "idle_gaps": trace["idle_gaps"]}
    result["card"] = run.card
    result["checks"] = {k: {"value": _json_number(c["value"]),
                            "limit": c["limit"]} for k, c in checks.items()}
    log(f"card {run.card['name']}, power limit "
        f"{run.card['power_limit_w']} W; window {window_s:.4f} s, "
        f"{len(solves)} solves, {failed} failed")
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
