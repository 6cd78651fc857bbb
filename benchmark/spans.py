"""Where the codec call spends its host time: the program's hot-path spans
read on the device trace's clock.

    python3 benchmark/spans.py --workload <name> --seed <n> [--turns 3] [--slice 2]

sets a cell up and warms it as `run.py` does, then runs `--turns` pairs of
traced slices of `--slice` seconds of the same closed loop under
torch.profiler, the program's span recorder (`hot_spans` of
`ceph_tpu_torch.common.tracer`, switched by its `bench_profile` knob) off
in one slice of a pair and on in the other, the order swapped each turn.
Standard error gets the clock check; the last line of standard output is
one JSON object: per slice with the recorder on, the per-layer span
metrics (`READERS`), the clock check and the device's idle time between
calls split five ways (`idle_gaps`); the host call (t0 to t1) of every
slice, on and off; the decode-table counters; and `correct`, the cell's
outputs judged as `run.py` judges them. Without a card it prints no
result and exits with 2; with a program that has no span recorder, 3.

The program only records raw intervals (name, parent, start_ns, end_ns) on
`time.perf_counter_ns()`; what they mean is the arithmetic here. Host
clocks map onto the trace's clock through one pair of readings
(`perf_counter_ns`, `time_ns`) taken as the slice opens. The map is
checked, not assumed: each `cudaLaunchKernel` of the slice's calls has to
lie inside a "gf.launch" span (the launcher's ctypes call). If fewer than
`CLOCK_SHARE` do, the offset is fitted as the median distance from each
launch event to its "gf.launch" span, the two taken in order (one launch
a call), and checked again.

`run.py` does not use this file: its traced slice (`devtrace.record`)
leaves the recorder off, and its `Run` carries no spans.
"""

from __future__ import annotations

import argparse
import bisect
import gc
import json
import os
import statistics
import sys
import tempfile
import time
from dataclasses import dataclass

import devtrace
import harness

#: the codec's entry spans (`ec/rs.py`), each the top of one call
ENTRY_SPANS = ("ec.encode_words", "ec.decode_words", "ec.encode_array", "ec.decode_array")
DECODE_SPANS = ("ec.decode_words", "ec.decode_array")
TABLE_SPAN = "ec.decode_table"
WRAPPER_SPAN = "gf.wrapper"
LAUNCH_SPAN = "gf.launch"
#: share of the slice's cudaLaunchKernel events that must lie in a
#: "gf.launch" span once mapped
CLOCK_SHARE = 0.99
#: the five parts of the device's idle time between calls: three of the
#: program's spans (a part nests in those before it), then the harness's
IDLE_PARTS = ("host path: codec entry", "host path: decode table",
              "host path: kernel wrapper and launch", "host path: event wait",
              "host path: harness step")
#: which part a span's name falls in
SPAN_PART = {**{name: 0 for name in ENTRY_SPANS}, TABLE_SPAN: 1, WRAPPER_SPAN: 2,
             LAUNCH_SPAN: 2}


@dataclass
class Traced:
    """One traced slice: the device's work, the harness's calls and the
    program's spans, with the map between their clocks."""

    slice: devtrace.Slice
    #: the harness's t0/t1/t2 of the slice's calls (perf_counter seconds)
    window: harness.Window
    #: the program's (name, parent, start_ns, end_ns) records
    spans: list[tuple]
    #: (start, end) of each cudaLaunchKernel of the trace, trace clock
    launches: list[tuple[float, float]]
    #: trace seconds less perf_counter seconds, from the pair of readings
    pair_offset: float
    #: the `ec_codec` block's counts over the slice
    counters: dict


def launch_mids(spans: list[tuple], offset: float) -> list[tuple[float, float]]:
    """(start, end) of each "gf.launch" span on the trace clock, in order."""
    return sorted((a / 1e9 + offset, b / 1e9 + offset)
                  for name, _, a, b in spans if name == LAUNCH_SPAN)


def loop_launches(spans: list[tuple], launches: list[tuple[float, float]]) -> list:
    """The launch events of the program's calls: the last as many as it
    recorded "gf.launch" spans (before them the trace holds only the
    launches of the op that opens it)."""
    n = sum(1 for r in spans if r[0] == LAUNCH_SPAN)
    return sorted(launches)[-n:] if n else []


def launch_share(spans: list[tuple], launches: list[tuple[float, float]],
                 offset: float) -> float:
    """Share of the calls' launch events (`loop_launches`) that lie inside a
    "gf.launch" span once its stamps are put on the trace clock with
    `offset` seconds."""
    inside = launch_mids(spans, offset)
    events = loop_launches(spans, launches)
    if not events:
        return 0.0
    starts = [a for a, _ in inside]
    hit = 0
    for a, b in events:
        i = bisect.bisect_right(starts, a) - 1
        hit += i >= 0 and b <= inside[i][1]
    return hit / len(events)


def fitted_offset(spans: list[tuple], launches: list[tuple[float, float]],
                  offset: float) -> float:
    """`offset` moved by the median distance from the midpoint of each of
    the calls' launch events to that of its "gf.launch" span, the two
    taken in order."""
    inside = launch_mids(spans, offset)
    events = loop_launches(spans, launches)
    n = min(len(inside), len(events))
    if not n:
        return offset
    return offset + statistics.median(
        (a + b) / 2 - (c + d) / 2 for (a, b), (c, d) in zip(events[-n:], inside[-n:]))


def clock(traced: Traced) -> dict:
    """The map from perf_counter seconds to the trace's: the pair's offset
    if it passes the check, else the fitted one; with both shares."""
    pair_share = launch_share(traced.spans, traced.launches, traced.pair_offset)
    out = {"pair_offset_s": traced.pair_offset, "pair_share": pair_share,
           "launches": len(loop_launches(traced.spans, traced.launches)),
           "fitted": pair_share < CLOCK_SHARE}
    offset = traced.pair_offset
    if out["fitted"]:
        offset = fitted_offset(traced.spans, traced.launches, offset)
    out["offset_s"] = offset
    out["share"] = launch_share(traced.spans, traced.launches, offset)
    return out


def span_seconds(spans: list[tuple], offset: float, lo: float, hi: float) -> dict:
    """Per span name: [spans that start in [lo, hi], their seconds inside
    it, their self seconds inside it (less the seconds of the spans that
    name them as parent)], on the trace clock (perf_counter + offset)."""
    out: dict[str, list] = {}
    children: dict[str, float] = {}
    for name, parent, a, b in spans:
        a, b = a / 1e9 + offset, b / 1e9 + offset
        inside = max(0.0, min(b, hi) - max(a, lo))
        entry = out.setdefault(name, [0, 0.0, 0.0])
        entry[0] += lo <= a <= hi
        entry[1] += inside
        if parent is not None:
            children[parent] = children.get(parent, 0.0) + inside
    for name, entry in out.items():
        entry[2] = entry[1] - children.get(name, 0.0)
    return out


def idle_parts(traced: Traced, offset: float, lo: float, hi: float) -> list[float]:
    """Seconds of [lo, hi] (trace clock) in which the device ran nothing,
    split by what the host was in: the innermost open span's part of
    `IDLE_PARTS` (codec entry, decode table, kernel wrapper and launch),
    else the event wait (t1 to t2 of a call), else the harness's step."""
    wait = len(IDLE_PARTS) - 2
    events = [(a, 1, -1) for _, a, b in traced.slice.device_ops] + \
        [(b, -1, -1) for _, a, b in traced.slice.device_ops]
    for name, _, a, b in traced.spans:
        part = SPAN_PART.get(name)
        if part is not None:
            events += [(a / 1e9 + offset, 1, part), (b / 1e9 + offset, -1, part)]
    for t1, t2 in zip(traced.window.t1, traced.window.t2):
        events += [(t1 + offset, 1, wait), (t2 + offset, -1, wait)]
    events.sort()
    busy = 0
    open_ = [0] * (wait + 1)
    seconds = [0.0] * len(IDLE_PARTS)
    at = lo
    for x, step, kind in events:
        if x > at and not busy:
            part = max((i for i, n in enumerate(open_) if n), default=len(IDLE_PARTS) - 1)
            seconds[part] += max(0.0, min(x, hi) - at)
        at = max(at, min(x, hi))
        if kind < 0:
            busy += step
        else:
            open_[kind] += step
    if not busy and hi > at:
        seconds[len(IDLE_PARTS) - 1] += hi - at
    return seconds


def idle_gaps(traced: Traced, offset: float) -> list[list]:
    """`Slice.idle_gaps()` with its one "host path between calls" entry
    split into the five `IDLE_PARTS`, which sum to it."""
    s = traced.slice
    if not s.device_ops:
        return s.idle_gaps()
    first = min(a for _, a, _ in s.device_ops)
    last = max(b for _, _, b in s.device_ops)
    named = list(zip(IDLE_PARTS, idle_parts(traced, offset, first, last)))
    named += [("before the first device op", first - s.start),
              ("after the last device op", s.stop - last)]
    return sorted(([k, v] for k, v in named if v > 0), key=lambda kv: -kv[1])


def per_call(traced: Traced, offset: float) -> tuple[dict, int]:
    """(span seconds by name over the slice, the slice's calls)."""
    s = traced.slice
    return span_seconds(traced.spans, offset, s.start, s.stop), len(s.batches)


def codec_entry_us(traced: Traced, offset: float):
    """Mean self time of the entry spans a call: `to_device`, slicing,
    checks, all the entry does outside its child spans."""
    sec, calls = per_call(traced, offset)
    total = sum(sec[n][2] for n in ENTRY_SPANS if n in sec)
    return total / calls * 1e6 if calls and total else None


def decode_table_us(traced: Traced, offset: float):
    """Mean "ec.decode_table" span a decode call."""
    sec, _ = per_call(traced, offset)
    decodes = sum(sec[n][0] for n in DECODE_SPANS if n in sec)
    if not decodes or TABLE_SPAN not in sec:
        return None
    return sec[TABLE_SPAN][1] / decodes * 1e6


def kernel_wrapper_us(traced: Traced, offset: float):
    """Mean self time of "gf.wrapper" a call: the wrappers' checks,
    `launch_tables`, the output's allocation, `on_device`'s stream."""
    sec, calls = per_call(traced, offset)
    if not calls or WRAPPER_SPAN not in sec:
        return None
    return sec[WRAPPER_SPAN][2] / calls * 1e6


def launch_call_us(traced: Traced, offset: float):
    """Mean "gf.launch" a call: the ctypes call into the launcher."""
    sec, calls = per_call(traced, offset)
    if not calls or LAUNCH_SPAN not in sec:
        return None
    return sec[LAUNCH_SPAN][1] / calls * 1e6


def program_idle_us(traced: Traced, offset: float):
    """Microseconds a call in which the device ran nothing while a span of
    the program was open: the idle time that is the program's own."""
    s = traced.slice
    if not s.batches or not s.device_ops or not traced.spans:
        return None
    parts = idle_parts(traced, offset, s.start, s.stop)
    return sum(parts[:3]) / len(s.batches) * 1e6


def decode_table_hit_pct(traced: Traced, offset: float):
    """Decode-table lookups in the slice that found their tables, in %."""
    hits = traced.counters.get("decode_table_hits", 0)
    looked = hits + traced.counters.get("decode_table_misses", 0)
    return 100.0 * hits / looked if looked else None


#: the per-layer metrics this tool reads, by name
READERS = {f.__name__: f for f in (codec_entry_us, decode_table_us, kernel_wrapper_us,
                                   launch_call_us, program_idle_us, decode_table_hit_pct)}


def is_launch(event: dict) -> bool:
    return (event.get("ph") == "X" and event.get("cat") == "cuda_runtime"
            and str(event.get("name", "")).startswith("cudaLaunchKernel"))


def record(loop, seconds: float, device, spans_on: bool) -> Traced:
    """Runs loop(seconds), which returns the harness's Window, under
    torch.profiler as `devtrace.record` does, with the program's recorder
    on if `spans_on`; returns the slice and what the program recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ceph_tpu_torch.common.config import config
    from ceph_tpu_torch.common.tracer import hot_spans
    from ceph_tpu_torch.ec.interface import codec_perf

    activity = ProfilerActivity.CUDA if device.type == "cuda" else ProfilerActivity.CPU
    with profile(activities=[activity]) as prof:
        torch.ones(1, device=device).add_(1)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        time.sleep(0.05)
        hot_spans.drain()
        config.set("bench_profile", spans_on)
        try:
            before = codec_perf.dump()
            p0 = time.perf_counter_ns()
            first = time.time_ns()
            p1 = time.perf_counter_ns()
            window = loop(seconds)
            last = time.time_ns()
        finally:
            config.set("bench_profile", False)
        after = codec_perf.dump()
    spans = hot_spans.drain()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    start, stop = (first - base) / 1e9, (last - base) / 1e9
    launches = [(e["ts"] / 1e6, (e["ts"] + e.get("dur", 0)) / 1e6)
                for e in doc["traceEvents"] if is_launch(e)]
    return Traced(devtrace.make_slice(devtrace.device_ops(doc), start, stop, window.jobs),
                  window, spans, launches, (first - base - (p0 + p1) / 2) / 1e9,
                  {k: after[k] - before[k] for k in after})


def summary(traced: Traced) -> dict:
    """The numbers of one slice with the recorder on."""
    check = clock(traced)
    offset = check["offset_s"]
    metrics = {name: read(traced, offset) for name, read in READERS.items()}
    host = statistics.fmean(traced.window.host_seconds()) * 1e6
    parts = sum(metrics[k] or 0.0 for k in ("codec_entry_us", "decode_table_us",
                                            "kernel_wrapper_us", "launch_call_us"))
    return {"metrics": {k: v for k, v in metrics.items() if v is not None},
            "clock": check, "host_call_us": host, "span_sum_us": parts,
            "calls": len(traced.slice.batches), "busy_s": traced.slice.busy_s,
            "window_s": traced.slice.window_s, "idle_gaps": idle_gaps(traced, offset),
            "counters": traced.counters}


def measure(name: str, seed: int, turns: int, slice_s: float, device,
            override: dict | None = None) -> dict:
    """The cell set up and warmed as `harness.run` does, then `turns` pairs
    of slices with the recorder off and on, the order swapped each turn."""
    import torch

    spec = harness.load_cell(name)
    config, traffic = dict(spec.config), dict(spec.traffic)
    for key, value in (override or {}).items():
        (config if key in config else traffic)[key] = value
    runner = harness.load_module(
        os.path.join(harness.BENCH_DIR, "runners", f"{traffic['runner']}.py"),
        f"bench_runner_{traffic['runner']}")
    cell = runner.Cell(config, traffic, seed, device)
    sync = harness.make_sync(device)
    for _ in range(harness.WARM_PASSES):
        harness.closed_loop(cell, 0.0, sync, harness.Keeper(seed))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    keep = harness.Keeper(seed)
    on, off = [], []
    gc.collect()
    gc.freeze()
    for turn in range(turns):
        for spans_on in ((False, True) if turn % 2 == 0 else (True, False)):
            traced = record(lambda s: harness.closed_loop(cell, s, sync, keep), slice_s,
                            device, spans_on)
            if spans_on:
                on.append(summary(traced))
            else:
                off.append(statistics.fmean(traced.window.host_seconds()) * 1e6)
            del traced
    gc.unfreeze()
    cell.release()
    checks, judged, wrong = cell.judge(keep.distinct())
    return {"workload": name, "seed": seed, "turns": turns, "slice_s": slice_s,
            "correct": all(v <= lim for v, lim in checks.values()), "judged": judged,
            "failed": wrong, "on": on, "host_call_off_us": off,
            "host_call_on_us": [s["host_call_us"] for s in on]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--turns", type=int, default=3)
    p.add_argument("--slice", type=float, default=harness.TRACE_SLICE_S)
    args = p.parse_args(argv)
    if harness.ROOT not in sys.path:
        sys.path.insert(1, harness.ROOT)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    try:
        from ceph_tpu_torch.common.tracer import hot_spans  # noqa: F401
    except ImportError as e:
        print(f"the program has no hot-path span recorder: {e}", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = measure(args.workload, args.seed, args.turns, args.slice, device)
    result["device"] = torch.cuda.get_device_name(device)
    for s in result["on"]:
        c = s["clock"]
        print(f"clock: {c['share']:.4f} of {c['launches']} launches inside gf.launch, "
              f"offset {c['offset_s']:.9f} s ({'fitted' if c['fitted'] else 'the pair'}; "
              f"the pair's share {c['pair_share']:.4f})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
