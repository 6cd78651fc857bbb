"""Perf counters — the reference's PerfCounters/PerfCountersCollection.

Re-expresses src/common/perf_counters.{h,cc}: subsystems
build a named counter block with `PerfCountersBuilder` (add_u64_counter /
add_u64 gauge / add_time_avg / add_histogram), bump them on the hot path
(`inc`, `set`, `tinc`, `hinc`), and operators read everything as the JSON tree
`perf dump` emits over the admin socket (avgcount/sum pairs for LONGRUNAVG,
perf_counters.cc:410-447).

Python-side cost discipline: counters are plain ints behind method calls; no
locks (the data path is single-process) and no formatting until dump time.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

U64 = "u64"           # gauge (PERFCOUNTER_U64)
U64_COUNTER = "ctr"   # monotonically increasing (| PERFCOUNTER_COUNTER)
TIME_AVG = "timeavg"  # (avgcount, sum-seconds) pair (PERFCOUNTER_LONGRUNAVG)
HISTOGRAM = "hist"    # value -> power-of-two bucket counts


@dataclass
class _Counter:
    type: str
    description: str = ""
    value: int = 0
    avgcount: int = 0
    sum: float = 0.0
    buckets: dict[int, int] = field(default_factory=dict)  # log2 -> count


class PerfCounters:
    """One named block of counters (reference: class PerfCounters)."""

    def __init__(self, name: str):
        self.name = name
        self._counters: dict[str, _Counter] = {}

    # -- builder ------------------------------------------------------------

    def add_u64(self, key: str, description: str = "") -> None:
        self._counters[key] = _Counter(U64, description)

    def add_u64_counter(self, key: str, description: str = "") -> None:
        self._counters[key] = _Counter(U64_COUNTER, description)

    def add_time_avg(self, key: str, description: str = "") -> None:
        self._counters[key] = _Counter(TIME_AVG, description)

    def add_histogram(self, key: str, description: str = "") -> None:
        self._counters[key] = _Counter(HISTOGRAM, description)

    # -- hot-path updates ---------------------------------------------------

    def inc(self, key: str, amount: int = 1) -> None:
        self._counters[key].value += amount

    def dec(self, key: str, amount: int = 1) -> None:
        self._counters[key].value -= amount

    def set(self, key: str, value: int) -> None:
        self._counters[key].value = value

    def set_max(self, key: str, value: int) -> None:
        """Raise a gauge to `value` only if it is higher — the
        peak/high-watermark gauge idiom (queue depth peaks, max backlog)
        that a plain `set` would overwrite on every sample."""
        c = self._counters[key]
        if value > c.value:
            c.value = value

    def tinc(self, key: str, seconds: float) -> None:
        c = self._counters[key]
        c.avgcount += 1
        c.sum += seconds

    def hinc(self, key: str, value: int) -> None:
        c = self._counters[key]
        bucket = max(0, int(value).bit_length() - 1)
        c.buckets[bucket] = c.buckets.get(bucket, 0) + 1

    def time(self, key: str):
        """Context manager: `with counters.time("op_latency"): ...`"""
        return _Timer(self, key)

    # -- dump ---------------------------------------------------------------

    def dump(self) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for key, c in self._counters.items():
            if c.type == TIME_AVG:
                out[key] = {"avgcount": c.avgcount, "sum": c.sum}
            elif c.type == HISTOGRAM:
                out[key] = {
                    str(1 << b): n for b, n in sorted(c.buckets.items())
                }
            else:
                out[key] = c.value
        return out

    def schema(self) -> dict[str, Any]:
        return {
            key: {"type": c.type, "description": c.description}
            for key, c in self._counters.items()
        }


class _Timer:
    def __init__(self, counters: PerfCounters, key: str):
        self._c, self._key = counters, key

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._c.tinc(self._key, time.perf_counter() - self._t0)
        return False


class PerfCountersCollection:
    """All blocks of a process (reference: PerfCountersCollection); `perf
    dump` walks every registered block."""

    def __init__(self):
        self._loggers: dict[str, PerfCounters] = {}

    def create(self, name: str) -> PerfCounters:
        logger = PerfCounters(name)
        self.add(logger)
        return logger

    def add(self, logger: PerfCounters) -> None:
        self._loggers[logger.name] = logger

    def remove(self, name: str) -> None:
        self._loggers.pop(name, None)

    def get(self, name: str) -> PerfCounters | None:
        return self._loggers.get(name)

    def dump(self) -> dict[str, Any]:
        return {name: l.dump() for name, l in sorted(self._loggers.items())}

    def schema(self) -> dict[str, Any]:
        return {name: l.schema() for name, l in sorted(self._loggers.items())}


#: process-wide default collection, like the CephContext-owned one
collection = PerfCountersCollection()
