"""The benchmark's run: a cell found by name, set up, warmed, timed, judged.

Everything that belongs to one cell is data found by name from
`BENCHMARK.json`: the configuration's file (its `file` entry), the traffic
file `traffic/<traffic>.json`, the runner that the traffic names
(`runners/<runner>.py`) and a reader per metric (`metrics/<metric>.py`,
a function `read(run)` that returns a number, or None where it finds
nothing to read). A later cell or metric is new files and new entries.

The window is a closed loop with one call in flight. Each batch is timed
on the host clock from just before the call, to its return, and to the
completion of a CUDA event recorded after it, so the host path, the
launch, the kernel and any stall count. Outputs are kept per job (a sample drawn from the seed
and the last one) and judged against the reference once the window has
closed, the peak memory has been read and the program's state is freed.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import random
import statistics
import sys
import time
from dataclasses import dataclass, field

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
#: the checkout: BENCHMARK.json and the program's package sit here
ROOT = os.path.dirname(BENCH_DIR)

#: seconds of the traced slice that follows the window in a --trace 1 run
TRACE_SLICE_S = 2.0
#: passes through every job before the window (the first builds and loads
#: the kernels and fills the decode-table cache; the others settle the
#: allocator's blocks for the outputs that the window keeps)
WARM_PASSES = 3
#: modules that no run may hold once its window has closed
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "ceph_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """The module at `path`, imported under `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot import {path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str):
    """The read(run) function of metrics/<name>.py."""
    safe = "bench_metric_" + "".join(c if c.isalnum() else "_" for c in name)
    return load_module(os.path.join(BENCH_DIR, "metrics", f"{name}.py"), safe).read


@dataclass
class CellSpec:
    """One workload of BENCHMARK.json with its files, loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    #: the metrics this cell reports: [(entry, trace flag)] in file order
    metrics: list = field(default_factory=list)


def load_cell(name: str, root: str = ROOT) -> CellSpec:
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (know {sorted(work)})")
    w = work[name]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = load_json(os.path.join(root, cfg["file"]))
    traffic = load_json(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json"))
    metrics = [(m, False) for m in spec["end_to_end"]]
    metrics += [(m, True) for m in spec["per_layer"]]
    metrics = [(m, t) for m, t in metrics if name in m.get("workloads", [name])]
    return CellSpec(name, int(w["chips"]), config, traffic, metrics)


class Keeper:
    """Keeps, per job, one output drawn uniformly from the seed among all
    of that job's calls (a reservoir of one) and the last output."""

    def __init__(self, seed: int):
        self.rng = random.Random(f"keep-{seed}")
        self.seen: dict[int, int] = {}
        self.held: dict[int, list] = {}

    def __call__(self, job: int, out) -> None:
        n = self.seen.get(job, 0) + 1
        self.seen[job] = n
        kept = self.held.get(job)
        if kept is None:
            self.held[job] = [out, out]
            return
        kept[1] = out
        if self.rng.random() * n < 1.0:
            kept[0] = out

    def distinct(self) -> dict[int, list]:
        return {j: ([a] if a is b else [a, b]) for j, (a, b) in self.held.items()}


@dataclass
class Window:
    """Per batch: the job's index, and the host clock before the call (t0),
    at its return (t1) and at the completion of its event (t2)."""

    jobs: list[int] = field(default_factory=list)
    t0: list[float] = field(default_factory=list)
    t1: list[float] = field(default_factory=list)
    t2: list[float] = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return self.t2[-1] - self.t0[0]

    def latencies(self) -> list[float]:
        return [b - a for a, b in zip(self.t0, self.t2)]

    def host_seconds(self) -> list[float]:
        return [b - a for a, b in zip(self.t0, self.t1)]


def make_sync(device):
    """A function that waits until the work queued so far on `device`'s
    current stream has run: a CUDA event recorded and waited on (one event,
    recorded again each time). On the CPU, work is done when it returns."""
    import torch

    if device.type != "cuda":
        return lambda: None
    event = torch.cuda.Event()

    def sync():
        event.record()
        event.synchronize()
    return sync


def closed_loop(cell, seconds: float, sync, keep) -> Window:
    """Runs the cell's jobs in turn, one call in flight, until `seconds` have
    passed and the pass through the jobs under way is complete."""
    window = Window()
    calls = [job.call for job in cell.jobs]
    n = len(calls)
    perf = time.perf_counter
    append_j, append_0 = window.jobs.append, window.t0.append
    append_1, append_2 = window.t1.append, window.t2.append
    i = 0
    stop = perf() + seconds
    while True:
        j = i % n
        t0 = perf()
        out = calls[j]()
        t1 = perf()
        sync()
        t2 = perf()
        keep(j, out)
        append_j(j)
        append_0(t0)
        append_1(t1)
        append_2(t2)
        del out
        i += 1
        if t2 >= stop and j == n - 1:
            return window


@dataclass
class Run:
    """What a run recorded, as the metric readers see it."""

    setup_s: float
    jobs: list
    window: Window
    device_name: str
    trace: object = None


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES)


def run(name: str, seed: int, seconds: float, trace: bool, device, started: float,
        root: str = ROOT, make_codec=None, override: dict | None = None) -> dict:
    """One run of workload `name`; returns the result line's object, with the
    compared numbers under "checks" (last), and {"error": ...} where the
    run cannot report. `started` is the host clock at the process's start.
    `make_codec` and `override` (traffic or configuration keys) serve the
    benchmark's own tests: the command line has neither."""
    import torch

    cell_spec = load_cell(name, root)
    config, traffic = dict(cell_spec.config), dict(cell_spec.traffic)
    for key, value in (override or {}).items():
        (config if key in config else traffic)[key] = value
    runner = load_module(os.path.join(BENCH_DIR, "runners", f"{traffic['runner']}.py"),
                         f"bench_runner_{traffic['runner']}")
    kwargs = {} if make_codec is None else {"make_codec": make_codec}
    marks = [time.perf_counter()]
    cell = runner.Cell(config, traffic, seed, device, **kwargs)
    sync = make_sync(device)
    sync()
    marks.append(time.perf_counter())
    for _ in range(WARM_PASSES):
        closed_loop(cell, 0.0, sync, Keeper(seed))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    marks.append(time.perf_counter())
    setup_s = marks[-1] - started
    print(f"setup: to the cell {marks[0] - started:.3f} s, inputs and codec "
          f"{marks[1] - marks[0]:.3f} s, warm-up {marks[2] - marks[1]:.3f} s", file=sys.stderr)

    gc.collect()
    gc.freeze()
    keep = Keeper(seed)
    window = closed_loop(cell, seconds, sync, keep)
    slice_ = None
    if trace:
        import devtrace

        slice_ = devtrace.record(lambda s: closed_loop(cell, s, sync, keep),
                                 min(TRACE_SLICE_S, seconds), device)
    gc.unfreeze()
    print(f"setup {setup_s:.3f} s; {window_summary(window)}", file=sys.stderr)
    if slice_ is not None:
        print(f"traced slice {slice_.window_s:.3f} s, {len(slice_.batches)} batches, "
              f"{len(slice_.device_ops)} device ops, busy {slice_.busy_s:.6f} s",
              file=sys.stderr)

    on_card = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    jobs = cell.jobs
    cell.release()
    held = keep.distinct()
    checks, judged, wrong = cell.judge(held)
    del held, keep

    found = forbidden_modules()
    if found:
        return {"error": f"modules of JAX or the JAX package loaded: {found}"}

    record = Run(setup_s, jobs, window,
                 torch.cuda.get_device_name(device) if on_card else "cpu", slice_)
    metrics = {}
    for entry, per_layer in cell_spec.metrics:
        if per_layer != trace:
            continue
        value = metric_reader(entry["name"])(record)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    attempted = len(window.jobs) + (len(slice_.batches) if slice_ else 0)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": record.device_name, "count": cell_spec.chips,
           "memory_peak_bytes": peak}
    out = {"correct": all(v <= lim for v, lim in checks.values()),
           "attempted": attempted, "failed": wrong, "metrics": metrics, "device": dev}
    if slice_ is not None:
        dev["busy_s"] = slice_.busy_s
        dev["window_s"] = slice_.window_s
        out["breakdown"] = {"device_ops": slice_.top_ops(), "idle_gaps": slice_.idle_gaps()}
    out["judged_outputs"] = judged
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return out


def window_summary(window: Window) -> str:
    """One line on the window, for standard error."""
    lat = window.latencies()
    return (f"window {window.seconds:.3f} s, {len(lat)} batches, latency median "
            f"{statistics.median(lat) * 1e3:.4f} ms, host call mean "
            f"{statistics.fmean(window.host_seconds()) * 1e6:.2f} us")
