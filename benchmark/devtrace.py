"""Device trace of a slice of the window: torch.profiler, read back whole.

The profiler records only the card's work (CUPTI: kernels, copies, sets,
and the runtime calls it correlates them with). Host work is not traced:
recording the host's operations and ranges doubled the host path of a
call (37 to 83 us a batch on an H100), where this costs 10-20 us. The
Chrome trace is read back for the device operations that fall inside the
slice, between two readings of the wall clock taken around the harness's
loop (the trace's times are `baseTimeNanoseconds` plus `ts` on the wall
clock), and for their union: the seconds the device was busy.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass

import yardstick

#: Chrome-trace categories of work on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Slice:
    """What the trace saw between the slice's start and stop (seconds after
    the trace's base time), and the harness's batches in it."""

    start: float
    stop: float
    #: (name, start, end) of each device operation in the slice
    device_ops: list[tuple[str, float, float]]
    #: job indices of the batches, in order
    batches: list[int]

    @property
    def window_s(self) -> float:
        return self.stop - self.start

    @property
    def busy_s(self) -> float:
        return yardstick.union_seconds((a, b) for _, a, b in self.device_ops)

    def top_ops(self, n: int = 10) -> list[list]:
        """The n device operations that took most time, by name."""
        total: dict[str, float] = defaultdict(float)
        for name, a, b in self.device_ops:
            total[name] += b - a
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self) -> list[list]:
        """The device's idle seconds in the slice: between its operations (in
        a closed loop with one call in flight, the host path: the wait's
        end, the harness's step, the codec call up to its launch), before
        its first and after its last."""
        if not self.device_ops:
            return [["no device operation", self.window_s]]
        head = min(a for _, a, _ in self.device_ops) - self.start
        tail = self.stop - max(b for _, _, b in self.device_ops)
        named = [["host path between calls (codec entry, launch, event wait, harness step)",
                  self.window_s - self.busy_s - head - tail],
                 ["before the first device op", head], ["after the last device op", tail]]
        return sorted(([k, v] for k, v in named if v > 0), key=lambda kv: -kv[1])


def device_ops(doc: dict) -> list[tuple[str, float, float]]:
    """(name, start, end) in seconds after the trace's base time of each
    device operation of a Chrome trace (`ts` and `dur` in microseconds)."""
    out = []
    for e in doc["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES:
            a = e["ts"] / 1e6
            out.append((e["name"], a, a + e.get("dur", 0) / 1e6))
    return out


def make_slice(ops, start: float, stop: float, batches: list[int]) -> Slice:
    """The Slice of [start, stop] (trace clock) within trace operations `ops`,
    each clipped to it."""
    inside = [(n, max(a, start), min(b, stop)) for n, a, b in ops if b > start and a < stop]
    return Slice(start, stop, inside, list(batches))


def record(loop, seconds: float, device) -> Slice:
    """Runs loop(seconds), which returns the harness's Window, under
    torch.profiler; returns what the trace saw in it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # the first launches after the profiler starts can come back without
        # device events: open it with a small op and a pause, outside the slice
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize(device)
        time.sleep(0.05)
        first = time.time_ns()
        window = loop(seconds)
        last = time.time_ns()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    return make_slice(device_ops(doc), (first - base) / 1e9, (last - base) / 1e9,
                      window.jobs)
