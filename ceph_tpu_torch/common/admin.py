"""Admin command hub + in-flight op tracker.

Two small pieces of the reference's observability plumbing:

  * `AdminCommands` — the admin-socket command table
    (src/common/admin_socket.cc: per-daemon unix socket
    answering `ceph daemon <name> <cmd>`). In-process here (no socket): the
    built-ins `perf dump`, `perf schema`, `config show`, `config get/set`,
    and `dump_ops_in_flight`/`dump_historic_ops` return the same JSON trees;
    subsystems register extra handlers by prefix.
  * `OpTracker` / `TrackedOp` — the always-on per-op event timeline
    (src/common/TrackedOp.h:102,201): ops mark named events
    with timestamps, land in a bounded history ring on completion, and
    anything alive longer than `slow_op_seconds` is reported by
    dump_ops_in_flight — the "slow request" mechanism.
"""

from __future__ import annotations

import heapq
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

from ceph_tpu_torch.common.config import config as global_config
from ceph_tpu_torch.common.perf_counters import collection as global_perf


@dataclass
class TrackedOp:
    description: str
    start: float = field(default_factory=time.time)
    events: list[tuple[float, str]] = field(default_factory=list)
    done: float | None = None
    #: the op's tracer span when the request is sampled (TrackedOp and
    #: the trace are two views of one op — dump_historic_ops shows the
    #: span timeline, dump_tracing the cross-daemon tree)
    span: Any = None
    id: int = -1
    #: slow-request warning already emitted for this op
    warned: bool = False

    def mark_event(self, event: str) -> None:
        self.events.append((time.time(), event))
        if self.span is not None:
            self.span.log(event)

    @property
    def duration(self) -> float:
        return (self.done or time.time()) - self.start

    def dump(self) -> dict[str, Any]:
        out = {
            "description": self.description,
            "initiated_at": self.start,
            "age": self.duration,
            "events": [
                {"time": t, "event": e} for t, e in self.events
            ],
        }
        if self.span is not None:
            out["trace_id"] = self.span.trace_id
            out["span"] = {
                "span_id": self.span.span_id,
                "name": self.span.name,
                "duration": self.span.duration,
                "events": [
                    {"time": t, "event": e, "offset": t - self.span.start}
                    for t, e in self.span.events
                ],
            }
        return out


class OpTracker:
    def __init__(self, history_size: int = 20,
                 slow_op_seconds: float = 30.0, on_slow=None):
        self.history_size = history_size
        self.slow_op_seconds = slow_op_seconds
        #: callback(op_id, op_dump) fired by check_slow() the first time
        #: an op crosses slow_op_seconds (the "slow request" cluster-log
        #: warning hook)
        self.on_slow = on_slow
        self._in_flight: dict[int, TrackedOp] = {}
        self._history: deque[TrackedOp] = deque(maxlen=history_size)
        #: top-K finished ops by duration (min-heap of (duration, id, op)).
        #: A separate view from the recency ring: a burst of fast ops
        #: evicts a slow one from _history within seconds, but the slow
        #: op is exactly the one worth keeping for diagnosis
        #: (dump_historic_ops_by_duration in the reference).
        self._slowest: list[tuple[float, int, TrackedOp]] = []
        self._next_id = 0

    def create(self, description: str, span=None) -> tuple[int, TrackedOp]:
        op = TrackedOp(description, span=span)
        op_id = self._next_id
        op.id = op_id
        self._next_id += 1
        self._in_flight[op_id] = op
        return op_id, op

    def finish(self, op_id: int) -> None:
        op = self._in_flight.pop(op_id, None)
        if op is not None:
            op.done = time.time()
            self._history.append(op)
            entry = (op.duration, op.id, op)
            if len(self._slowest) < self.history_size:
                heapq.heappush(self._slowest, entry)
            elif entry[0] > self._slowest[0][0]:
                heapq.heapreplace(self._slowest, entry)

    @property
    def num_in_flight(self) -> int:
        """Tracked ops currently executing — the cheap count the mgr
        report tick ships (dump_ops_in_flight formats every op)."""
        return len(self._in_flight)

    def track(self, description: str, span=None) -> "_TrackCtx":
        """Context manager tracking one op."""
        return _TrackCtx(self, description, span)

    def check_slow(self) -> list[tuple[int, dict]]:
        """Scan in-flight ops for first-time slow_op_seconds crossings
        (OpTracker::check_ops_in_flight): each newly-slow op is reported
        ONCE — via on_slow and the returned list — the moment a periodic
        check sees it, instead of waiting for someone to poll
        dump_ops_in_flight."""
        newly_slow = []
        for op_id, op in self._in_flight.items():
            if op.warned or op.duration < self.slow_op_seconds:
                continue
            op.warned = True
            if op.span is not None:
                op.span.log("slow_request")
                op.span.set_tag("slow", True)
            newly_slow.append((op_id, op.dump()))
        if self.on_slow is not None:
            for op_id, dump in newly_slow:
                self.on_slow(op_id, dump)
        return newly_slow

    def dump_ops_in_flight(self) -> dict[str, Any]:
        ops = [op.dump() for op in self._in_flight.values()]
        slow = [o for o in ops if o["age"] >= self.slow_op_seconds]
        return {"num_ops": len(ops), "ops": ops, "num_slow_ops": len(slow)}

    def dump_historic_ops(self) -> dict[str, Any]:
        return {
            "num_ops": len(self._history),
            "ops": [op.dump() for op in self._history],
            "slowest": [
                op.dump()
                for _, _, op in sorted(
                    self._slowest, key=lambda e: e[0], reverse=True
                )
            ],
        }


class _TrackCtx:
    __slots__ = ("_tracker", "_description", "_span", "_op_id")

    def __init__(self, tracker: OpTracker, description: str, span=None):
        self._tracker = tracker
        self._description = description
        self._span = span

    def __enter__(self) -> TrackedOp:
        self._op_id, op = self._tracker.create(
            self._description, span=self._span
        )
        return op

    def __exit__(self, *exc):
        self._tracker.finish(self._op_id)
        return False


class AdminCommands:
    """Command-string -> handler table with the reference's built-ins."""

    def __init__(self, perf=None, config=None,
                 op_tracker: OpTracker | None = None, tracer=None):
        self._perf = perf if perf is not None else global_perf
        self._config = config if config is not None else global_config
        self._tracker = op_tracker or OpTracker()
        self._tracer = tracer
        self._handlers: dict[str, Callable[..., Any]] = {}
        if tracer is not None:
            self.register("dump_tracing", tracer.dump_tracing)
        self.register("perf dump", lambda: self._perf.dump())
        self.register("perf schema", lambda: self._perf.schema())
        self.register("config show", lambda: self._config.show())
        self.register("config get", lambda name: {
            name: self._config.get(name)
        })
        self.register("config set", self._config_set)
        self.register(
            "dump_ops_in_flight", self._tracker.dump_ops_in_flight
        )
        self.register("dump_historic_ops", self._tracker.dump_historic_ops)

    @property
    def op_tracker(self) -> OpTracker:
        return self._tracker

    def _config_set(self, name: str, *value_parts: str) -> dict[str, str]:
        # accept space-containing values from the single-string dispatch
        # form ("config set <name> plugin=tpu k=8 m=3")
        self._config.set(name, " ".join(str(v) for v in value_parts))
        return {"success": f"{name} = {self._config.get(name)}"}

    def register(self, command: str, handler: Callable[..., Any]) -> None:
        self._handlers[command] = handler

    def handle(self, command: str, *args: str) -> Any:
        """Dispatch `command` (longest-prefix match so 'config set x y'
        parses as command 'config set' + args)."""
        if command in self._handlers:
            return self._handlers[command](*args)
        parts = command.split()
        for take in range(len(parts) - 1, 0, -1):
            prefix = " ".join(parts[:take])
            if prefix in self._handlers:
                return self._handlers[prefix](*parts[take:], *args)
        raise KeyError(f"unknown admin command {command!r}")
