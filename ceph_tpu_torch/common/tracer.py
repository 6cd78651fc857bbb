"""Distributed tracing — the reference's src/common/tracer + blkin role.

A Dapper-style tracer (Sigelman et al. 2010): every sampled request gets
a trace id; each timed unit of work is a span (span_id, parent_id) with
tags and timestamped events; the (trace_id, span_id, sampled) context
travels across daemons as an optional field on the wire `Message`, so a
span started in the Rados client continues through the messenger, the
OSD op queue, the encode service, and the object store, and forks a
child span per replica/EC-shard sub-op — the same shape Ceph gets from
jaeger-tracing wired through ProtocolV2 (src/common/tracer.h,
src/msg/async/ProtocolV2.cc encode_trace).

Pieces:

  * `SpanContext` — the wire form, one compact string
    "<trace_id>:<span_id>:<flags>" (flags bit0 = sampled, bit1 =
    flight-recorded), carried by `Message.trace` (msg/frames.py).
  * `Span` — timed unit with tags + events; `finish()` lands it in the
    tracer's bounded completed-span ring, feeds a per-span-name
    PerfCounters latency histogram (picked up by `perf dump` and the
    Prometheus exporter), and appends one Jaeger-compatible JSON line
    to `tracer_export_path` when set (tools/trace_tool.py renders it).
  * `Tracer` — per-daemon factory. Config knobs (central schema):
    `tracer_enabled`, `tracer_sample_rate`, `tracer_ring_size`,
    `tracer_export_path`, plus per-op-type `tracer_sample_rate_<type>`
    root-rate overrides (-1 inherits; recovery reads can run at 100%
    while steady-state IO stays sampled); all observed at runtime like
    debug levels.

Flight recorder / tail sampling (the Canopy shape, Kaldor et al. 2017):
with the tracer enabled, EVERY op records spans — head sampling only
decides which spans are *exported* up front. Unsampled spans carry
``sampled=False`` and land in a separate bounded flight ring (Span
objects, no dict built on the hot path) where the keep/drop decision
moves to op COMPLETION: a tail-eligible root span (``tail=True``) is
promoted when it is slow (`tracer_tail_slow_ms`), among the slowest-N
of its window (`tracer_tail_top_n`/`tracer_tail_window_s`), carries an
error/retry/redirect tag (`tracer_tail_errors`), or matches an
mgr-pushed SLO capture predicate (budgeted per window by
`tracer_tail_capture_per_window`). Promoted traces sit in a small
outbox drained by the daemon's mgr report tick (`drain_promoted`),
their trace ids ride as OpenMetrics exemplars on the latency
histograms (`exemplars`), and the whole flight ring is the crash
black-box payload (`flight_snapshot`) when a daemon fences.

Cost discipline (the dout-gate idiom, common/log.py): the enabled flag
is CACHED and checked first in every factory method, so a disabled
tracer costs one flag check per span site and allocates nothing:

    if (sp := tracer.child("blockstore_read")) is not None:
        sp.set_tag("cache", "hit")
        sp.finish()

The task-local current context (`use`/`use_wire`) rides a contextvar so
awaits and `create_task` propagate it without plumbing; `child()`
returns None when no sampled context is active — interior span sites
never start traces of their own.

Hot path: a `Span` costs several microseconds, too much inside one codec
call of 20-50 us. `hot_spans`, a `HotSpanRecorder`, records the codec
call's layer boundaries (its entries, the decode-table lookup, the kernel
wrappers' host path and the launch) as bare (name, parent, start_ns,
end_ns) tuples on `time.perf_counter_ns()`, behind the same cached-flag
gate, switched by the `bench_profile` knob.
"""

from __future__ import annotations

import contextvars
import heapq
import json
import os
import random
import time
from collections import deque
from typing import Any

from ceph_tpu_torch.common.config import Config, ConfigError
from ceph_tpu_torch.common.config import config as global_config
from ceph_tpu_torch.common.perf_counters import PerfCounters

#: the active span context for the op executing in this task/thread
_current: "contextvars.ContextVar[SpanContext | None]" = (
    contextvars.ContextVar("ceph_tracer_ctx", default=None)
)


def current_context() -> "SpanContext | None":
    return _current.get()


def current_trace_id() -> str | None:
    """Trace id of the active context, for log correlation (the
    `trace=<id>` dout prefix); None when untraced."""
    ctx = _current.get()
    return None if ctx is None else ctx.trace_id


#: op types with a `tracer_sample_rate_<type>` schema entry — keeps the
#: cached-rate table in lockstep with common/config.py
_OP_RATE_TYPES = (
    "read", "write", "ops", "delete", "call", "stat", "recovery",
    "command", "balancer",
)


class SpanContext:
    """What propagates: ids + the keep-decision flags, never payload.

    Flags: bit0 = sampled (head decision, export up front), bit1 =
    flight-only (record into the receiver's flight ring; the keep/drop
    decision happens at op completion). A context with neither bit is
    dead weight and decodes to an untraceable context."""

    __slots__ = ("trace_id", "span_id", "sampled", "flight")

    def __init__(self, trace_id: str, span_id: str, sampled: bool = True,
                 flight: bool = False):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled
        self.flight = flight

    def encode(self) -> str:
        flags = (1 if self.sampled else 0) | (2 if self.flight else 0)
        return f"{self.trace_id}:{self.span_id}:{flags}"

    @staticmethod
    def decode(raw: str | None) -> "SpanContext | None":
        if not raw:
            return None
        parts = raw.split(":")
        if len(parts) != 3 or not parts[0] or not parts[1]:
            return None
        try:
            flags = int(parts[2] or 0)
        except ValueError:
            return None
        return SpanContext(
            parts[0], parts[1], bool(flags & 1), bool(flags & 2)
        )


class Span:
    __slots__ = (
        "_tracer", "trace_id", "span_id", "parent_id", "name",
        "service", "start", "end", "tags", "events", "sampled", "tail",
    )

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 span_id: str, parent_id: str | None,
                 tags: dict | None, start: float | None,
                 sampled: bool = True, tail: bool = False):
        self._tracer = tracer
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.service = tracer.service
        self.start = time.time() if start is None else start
        self.end: float | None = None
        self.tags: dict[str, Any] = dict(tags) if tags else {}
        self.events: list[tuple[float, str]] = []
        #: head decision: export to ring/JSONL on finish
        self.sampled = sampled
        #: tail-eligible ROOT: finish() runs the keep/drop predicates
        self.tail = tail

    # -- recording ------------------------------------------------------------

    def log(self, event: str) -> None:
        self.events.append((time.time(), event))

    def set_tag(self, key: str, value: Any) -> None:
        self.tags[key] = value

    def context(self) -> SpanContext:
        return SpanContext(
            self.trace_id, self.span_id, self.sampled,
            flight=not self.sampled,
        )

    @property
    def duration(self) -> float:
        return (self.end if self.end is not None else time.time()) - self.start

    def finish(self) -> None:
        """Close the span (idempotent): ring + perf histogram + export."""
        if self.end is not None:
            return
        self.end = time.time()
        self._tracer._finished(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> bool:
        self.finish()
        return False

    # -- serialization --------------------------------------------------------

    def dump(self) -> dict:
        """The admin-surface (`dump_tracing`) form."""
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "service": self.service,
            "start": self.start,
            "duration": self.duration,
            "tags": {k: _jsonable(v) for k, v in self.tags.items()},
            "events": [
                {"ts": ts, "event": ev} for ts, ev in self.events
            ],
        }

    def to_jaeger(self) -> dict:
        """One span in Jaeger JSON (the jaeger-ui import format; µs)."""
        refs = []
        if self.parent_id:
            refs.append({
                "refType": "CHILD_OF",
                "traceID": self.trace_id,
                "spanID": self.parent_id,
            })
        return {
            "traceID": self.trace_id,
            "spanID": self.span_id,
            "operationName": self.name,
            "references": refs,
            "startTime": int(self.start * 1e6),
            "duration": int(self.duration * 1e6),
            "tags": [
                {"key": k, "type": "string", "value": str(v)}
                for k, v in self.tags.items()
            ],
            "logs": [
                {"timestamp": int(ts * 1e6),
                 "fields": [{"key": "event", "value": ev}]}
                for ts, ev in self.events
            ],
            "process": {"serviceName": self.service, "tags": []},
        }


def _jsonable(v):
    return v if isinstance(v, (str, int, float, bool, type(None))) else str(v)


class Tracer:
    """Per-daemon span factory + bounded completed-span ring."""

    def __init__(self, service: str, config: Config | None = None):
        self.service = service
        cfg = config if config is not None else global_config
        self._rng = random.Random()
        self._on = False
        self._rate = 1.0
        #: per-op-type sample-rate overrides (tracer_sample_rate_<type>):
        #: only types with a non-negative override are present, so the
        #: common case stays one dict-get against an empty dict
        self._op_rates: dict[str, float] = {}
        self._export_path = ""
        ring_size = 1024
        flight_size = 2048
        #: tail-sampling knobs (cached, config-observed)
        self._tail_slow_ms = 1000.0
        self._tail_top_n = 0
        self._tail_window = 10.0
        self._tail_errors = True
        self._tail_budget = 2
        try:
            self._on = bool(cfg.get("tracer_enabled"))
            self._rate = float(cfg.get("tracer_sample_rate"))
            self._export_path = cfg.get("tracer_export_path")
            ring_size = int(cfg.get("tracer_ring_size"))
            cfg.observe("tracer_enabled", self._on_enabled)
            cfg.observe("tracer_sample_rate", self._on_rate)
            cfg.observe("tracer_export_path", self._on_export)
            cfg.observe("tracer_ring_size", self._on_ring)
            for t in _OP_RATE_TYPES:
                name = f"tracer_sample_rate_{t}"
                try:
                    rate = float(cfg.get(name))
                except ConfigError:
                    continue  # older/custom schema without this type
                if rate >= 0:
                    self._op_rates[t] = rate
                cfg.observe(name, self._make_op_rate_cb(t))
            flight_size = int(cfg.get("tracer_flight_ring_size"))
            self._tail_slow_ms = float(cfg.get("tracer_tail_slow_ms"))
            self._tail_top_n = int(cfg.get("tracer_tail_top_n"))
            self._tail_window = float(cfg.get("tracer_tail_window_s"))
            self._tail_errors = bool(cfg.get("tracer_tail_errors"))
            self._tail_budget = int(
                cfg.get("tracer_tail_capture_per_window")
            )
            cfg.observe("tracer_flight_ring_size", self._on_flight_ring)
            cfg.observe("tracer_tail_slow_ms", self._on_tail_slow)
            cfg.observe("tracer_tail_top_n", self._on_tail_top)
            cfg.observe("tracer_tail_window_s", self._on_tail_window)
            cfg.observe("tracer_tail_errors", self._on_tail_errors)
            cfg.observe(
                "tracer_tail_capture_per_window", self._on_tail_budget
            )
        except ConfigError:
            pass  # custom schema without tracer options: stay disabled
        self._ring: deque[dict] = deque(maxlen=max(1, ring_size))
        #: the always-on flight ring: EVERY completed span (Span objects
        #: for our own, dicts for adopted foreign ones); the tail
        #: keep/drop decision and the crash black-box read from here
        self._flight: deque = deque(maxlen=max(1, flight_size))
        #: span name -> cached lat_us_* histogram key (hot-path string
        #: sanitation done once per distinct name)
        self._hist_keys: dict[str, str] = {}
        #: tail window state: slowest-N candidates + capture budgets
        self._win_start = time.time()
        self._win_seq = 0
        self._win_top: list = []
        #: mgr-pushed SLO capture predicates ([{name, min_ms}]) + the
        #: version that acked them over the report channel
        self._captures: list[dict] = []
        self._capture_ver = 0
        self._capture_hits: dict[str, int] = {}
        #: promotion outbox (trace_id -> meta) drained by the mgr
        #: report tick / the client relay, plus an LRU of already
        #: promoted ids so relays and re-decisions never double-ship
        self._promoted: dict[str, dict] = {}
        self._promoted_seen: dict[str, None] = {}
        #: latest promoted exemplar per latency histogram key
        self._exemplars: dict[str, dict] = {}
        #: span latency histograms (lat_us_<name>), adopted into the
        #: daemon's PerfCountersCollection so `perf dump` and the
        #: Prometheus exporter surface span timings as metrics
        self.perf = PerfCounters("tracer")
        self._export_fh = None

    # -- config observers (cached-flag refresh, the dout-gate idiom) ----------

    def _on_enabled(self, _n, v) -> None:
        self._on = bool(v)

    def _on_rate(self, _n, v) -> None:
        self._rate = float(v)

    def _on_export(self, _n, v) -> None:
        if self._export_fh is not None:
            try:
                self._export_fh.close()
            except OSError:
                pass
            self._export_fh = None
        self._export_path = v

    def _on_ring(self, _n, v) -> None:
        self._ring = deque(self._ring, maxlen=max(1, int(v)))

    def _on_flight_ring(self, _n, v) -> None:
        self._flight = deque(self._flight, maxlen=max(1, int(v)))

    def _on_tail_slow(self, _n, v) -> None:
        self._tail_slow_ms = float(v)

    def _on_tail_top(self, _n, v) -> None:
        self._tail_top_n = int(v)

    def _on_tail_window(self, _n, v) -> None:
        self._tail_window = float(v)

    def _on_tail_errors(self, _n, v) -> None:
        self._tail_errors = bool(v)

    def _on_tail_budget(self, _n, v) -> None:
        self._tail_budget = int(v)

    def _make_op_rate_cb(self, op_type: str):
        def cb(_n, v) -> None:
            rate = float(v)
            if rate < 0:
                self._op_rates.pop(op_type, None)  # back to inheriting
            else:
                self._op_rates[op_type] = rate

        return cb

    @property
    def enabled(self) -> bool:
        return self._on

    # -- span factories -------------------------------------------------------

    def start(self, name: str, tags: dict | None = None,
              start: float | None = None,
              op_type: str | None = None) -> Span | None:
        """Root span: begins a NEW trace. With the tracer on, a span is
        ALWAYS returned (the flight recorder records every op); the
        sample rate only decides the head `sampled` flag, i.e. whether
        the trace exports up front. `op_type` selects a
        `tracer_sample_rate_<type>` override when one is set (recovery
        reads at 100% while steady-state IO stays unsampled);
        unknown/unset types inherit the base rate. Roots are
        tail-eligible: finish() runs the keep/drop predicates. None
        only when the tracer is disabled."""
        if not self._on:
            return None
        rate = self._rate
        if op_type is not None and self._op_rates:
            rate = self._op_rates.get(op_type, rate)
        sampled = self._rng.random() < rate
        trace_id = f"{self._rng.getrandbits(64):016x}"
        return Span(self, name, trace_id, self._new_id(), None, tags,
                    start, sampled=sampled, tail=True)

    def child(self, name: str, tags: dict | None = None,
              start: float | None = None) -> Span | None:
        """Child of the task-local current context; None when disabled
        or untraced — interior sites never originate traces. Children
        inherit the parent's head decision (flight-only parents get
        flight-only children)."""
        if not self._on:
            return None
        ctx = _current.get()
        if ctx is None or not (ctx.sampled or ctx.flight):
            return None
        return Span(self, name, ctx.trace_id, self._new_id(),
                    ctx.span_id, tags, start, sampled=ctx.sampled)

    def join(self, wire: str | None, name: str, tags: dict | None = None,
             start: float | None = None, tail: bool = False) -> Span | None:
        """Continue a trace arriving over the wire (`Message.trace`).
        `tail=True` marks the joined span tail-eligible — the server-side
        op execution span (osd_op) runs its own keep/drop decision, so a
        server-slow op promotes even when the client never relays."""
        if not self._on:
            return None
        ctx = SpanContext.decode(wire)
        if ctx is None or not (ctx.sampled or ctx.flight):
            return None
        return Span(self, name, ctx.trace_id, self._new_id(),
                    ctx.span_id, tags, start, sampled=ctx.sampled,
                    tail=tail)

    def _new_id(self) -> str:
        return f"{self._rng.getrandbits(64):016x}"

    # -- current-context plumbing ---------------------------------------------

    def use(self, span: Span):
        """Make `span` the task-local parent for child()/fork sites;
        returns a token for release()."""
        return _current.set(span.context())

    def use_wire(self, wire: str | None):
        """Adopt a wire context as the task-local parent (sub-op
        handlers: their spans hang off the sender's fork span). Returns
        a token, or None when there is nothing to adopt."""
        if not self._on:
            return None
        ctx = SpanContext.decode(wire)
        if ctx is None or not (ctx.sampled or ctx.flight):
            return None
        return _current.set(ctx)

    def release(self, token) -> None:
        if token is not None:
            _current.reset(token)

    # -- completion / ring / export -------------------------------------------

    def _finished(self, span: Span) -> None:
        if span.sampled:
            self._ring.append(span.dump())
        # the always-on flight ring keeps the Span OBJECT — no dict is
        # built on the unsampled hot path; dumps materialize lazily at
        # promotion / black-box time
        self._flight.append(span)
        key = self._hist_keys.get(span.name)
        if key is None:
            key = "lat_us_" + "".join(
                c if c.isalnum() else "_" for c in span.name
            )
            self._hist_keys[span.name] = key
        if key not in self.perf._counters:
            self.perf.add_histogram(
                key, f"span {span.name!r} latency (µs, log2 buckets)"
            )
        us = max(1, int(span.duration * 1e6))
        self.perf.hinc(key, us)
        if span.sampled and self._export_path:
            self._export_jsonl(span)
        if span.tail:
            self._tail_decide(span, key, us)

    # -- tail sampling (keep/drop at op completion) ---------------------------

    def _tail_decide(self, span: Span, key: str, us: int) -> None:
        """Run the promotion predicates on a completed tail-eligible
        root: error tags first (an operator always wants those), then
        the slow threshold, then the mgr's SLO capture predicates
        (budgeted per window), else feed the slowest-N window heap."""
        now = span.end if span.end is not None else time.time()
        if now - self._win_start >= self._tail_window:
            self._flush_window(now)
        dur_ms = us / 1000.0
        tags = span.tags
        reason = None
        if self._tail_errors and (
            "error" in tags or "retried" in tags
            or "redirected" in tags or "aborted" in tags
        ):
            reason = "error"
        elif self._tail_slow_ms and dur_ms >= self._tail_slow_ms:
            reason = "slow"
        elif self._captures:
            for pred in self._captures:
                if dur_ms < float(pred.get("min_ms") or 0.0):
                    continue
                pname = pred.get("name", "slo")
                hits = self._capture_hits.get(pname, 0)
                if hits >= self._tail_budget:
                    continue
                self._capture_hits[pname] = hits + 1
                reason = f"slo:{pname}"
                break
        if reason is not None:
            self._promote_span(span, key, us, reason)
        elif self._tail_top_n:
            self._win_seq += 1
            item = (dur_ms, self._win_seq, span, key, us)
            if len(self._win_top) < self._tail_top_n:
                heapq.heappush(self._win_top, item)
            elif dur_ms > self._win_top[0][0]:
                heapq.heapreplace(self._win_top, item)

    def _flush_window(self, now: float) -> None:
        """Roll the tail window: promote the slowest-N candidates of
        the closing window and reset the per-predicate capture budgets."""
        self._win_start = now
        self._capture_hits.clear()
        top, self._win_top = self._win_top, []
        for _dur, _seq, span, key, us in top:
            self._promote_span(span, key, us, "slowest_n")

    def _promote_span(self, span: Span, key: str, us: int,
                      reason: str) -> None:
        if self._promote(span.trace_id, reason, root=span.dump()):
            self._exemplars[key] = {
                "trace_id": span.trace_id, "value": us,
                "ts": span.end if span.end is not None else time.time(),
            }

    def _promote(self, trace_id: str, reason: str,
                 root: dict | None = None) -> bool:
        if trace_id in self._promoted or trace_id in self._promoted_seen:
            return False
        self._promoted_seen[trace_id] = None
        while len(self._promoted_seen) > 512:
            self._promoted_seen.pop(next(iter(self._promoted_seen)))
        self._promoted[trace_id] = {
            "trace_id": trace_id, "reason": reason,
            "promoted_at": time.time(), "root": root,
        }
        while len(self._promoted) > 64:  # outbox bound: oldest drop
            self._promoted.pop(next(iter(self._promoted)))
        if "tail_promoted" not in self.perf._counters:
            self.perf.add_u64_counter(
                "tail_promoted",
                "traces promoted by the tail sampler",
            )
        self.perf.inc("tail_promoted")
        return True

    def promote(self, trace_id: str, reason: str = "relay",
                root: dict | None = None) -> bool:
        """Promote a trace by id — the relay path: a client that kept
        its trace ships the decision (trace_report) to the primary OSD,
        which promotes the same trace locally so its own flight spans —
        and the adopted client spans — ride the next mgr report. Also
        records an exemplar from OUR slowest tail-eligible flight span
        of the trace, so the server-side latency histogram carries the
        drill-down id too."""
        if not self._on or not trace_id:
            return False
        if not self._promote(trace_id, reason, root=root):
            return False
        best: Span | None = None
        for s in self._flight:
            if (
                isinstance(s, Span) and s.trace_id == trace_id
                and s.tail and (best is None or s.duration > best.duration)
            ):
                best = s
        if best is not None:
            key = self._hist_keys.get(best.name)
            if key is not None:
                self._exemplars[key] = {
                    "trace_id": trace_id,
                    "value": max(1, int(best.duration * 1e6)),
                    "ts": best.end if best.end is not None
                    else time.time(),
                }
        return True

    def flight_spans_of(self, trace_id: str) -> list[dict]:
        """Every flight-ring span of one trace as dump dicts, oldest
        first, deduped by span_id (relays may have adopted copies)."""
        out: list[dict] = []
        seen: set[str] = set()
        for s in self._flight:
            d = s.dump() if isinstance(s, Span) else s
            if d.get("trace_id") != trace_id or d["span_id"] in seen:
                continue
            seen.add(d["span_id"])
            out.append(d)
        out.sort(key=lambda d: d.get("start") or 0.0)
        return out

    def flight_has(self, trace_id: str) -> bool:
        """Does the flight ring still hold any span of this trace?
        (dump_historic_ops cross-links entries while it does.)"""
        return any(
            (s.trace_id if isinstance(s, Span) else s.get("trace_id"))
            == trace_id
            for s in self._flight
        )

    def adopt_flight(self, spans: list[dict]) -> None:
        """Accept foreign finished spans into the FLIGHT ring (the
        promotion relay: a client's unsampled spans must be present
        when its promoted trace is gathered) without touching the
        sampled ring — an unpromoted flight trace still leaves nothing
        behind in `dump_tracing`."""
        if not self._on:
            return
        for s in spans:
            if isinstance(s, dict) and "trace_id" in s and "span_id" in s:
                self._flight.append(s)

    def take_promoted(self, trace_id: str) -> dict | None:
        """Pop ONE promoted entry with its flight spans — the client
        relay path (no mgr report loop drains a client's tracer)."""
        meta = self._promoted.pop(trace_id, None)
        if meta is None:
            return None
        return {**meta, "spans": self._gathered(meta)}

    def drain_promoted(self) -> list[dict]:
        """Collect the promotion outbox (the daemon's mgr report tick):
        each entry carries every flight-ring span of its trace, gathered
        NOW so stragglers that finished after the keep decision are
        included. Also lazily rolls the tail window, so slowest-N
        promotion happens even when traffic stopped mid-window."""
        if self._win_top or self._capture_hits:
            now = time.time()
            if now - self._win_start >= self._tail_window:
                self._flush_window(now)
        if not self._promoted:
            return []
        out = [
            {**meta, "spans": self._gathered(meta)}
            for meta in self._promoted.values()
        ]
        self._promoted = {}
        return out

    def _gathered(self, meta: dict) -> list[dict]:
        spans = self.flight_spans_of(meta["trace_id"])
        root = meta.get("root")
        if root is not None and all(
            s["span_id"] != root["span_id"] for s in spans
        ):
            spans.insert(0, root)  # ring already evicted the root
        return spans

    def exemplars(self) -> dict[str, dict]:
        """Latest promoted-trace exemplar per latency histogram key
        ({trace_id, value µs, ts}) — ships on the mgr report and rides
        the Prometheus histograms as OpenMetrics exemplars."""
        return {k: dict(v) for k, v in self._exemplars.items()}

    def set_capture_predicates(self, preds, version) -> None:
        """Adopt mgr-pushed SLO capture predicates ([{name, min_ms}]):
        while a rule is in violation the mgr asks daemons to keep up to
        tracer_tail_capture_per_window matching traces per window."""
        self._captures = [
            p for p in (preds or [])
            if isinstance(p, dict) and p.get("name")
        ]
        self._capture_hits.clear()
        self._capture_ver = int(version)

    @property
    def capture_version(self) -> int:
        return self._capture_ver

    def flight_snapshot(self) -> list[dict]:
        """The crash black-box view: every flight-ring span as a dump
        dict, oldest first (finished spans only — in-flight ops come
        from the OpTracker's side of the black box)."""
        return [
            s.dump() if isinstance(s, Span) else s for s in self._flight
        ]

    def _export_jsonl(self, span: Span) -> None:
        try:
            if self._export_fh is None:
                # O_APPEND: many daemons may share one collector file
                self._export_fh = open(self._export_path, "a")
            self._export_fh.write(json.dumps(span.to_jaeger()) + "\n")
            self._export_fh.flush()
        except OSError:
            self._export_path = ""  # unwritable path: disable, not crash

    def adopt(self, spans: list[dict]) -> None:
        """Accept foreign finished spans into the ring — the Jaeger
        collector role: clients report their half of a trace to the
        primary OSD so `dump_tracing` there holds the complete tree."""
        if not self._on:
            return
        for s in spans:
            if isinstance(s, dict) and "trace_id" in s and "span_id" in s:
                self._ring.append(s)

    def spans_of(self, trace_id: str) -> list[dict]:
        return [s for s in self._ring if s["trace_id"] == trace_id]

    def dump_tracing(self, drain: bool = True) -> dict:
        """The `dump_tracing` admin command: completed spans grouped by
        trace, oldest span first within each; drains the ring."""
        spans = list(self._ring)
        if drain:
            self._ring.clear()
        traces: dict[str, list[dict]] = {}
        for s in spans:
            traces.setdefault(s["trace_id"], []).append(s)
        return {
            "num_traces": len(traces),
            "num_spans": len(spans),
            "traces": [
                {"trace_id": tid,
                 "spans": sorted(ss, key=lambda s: s["start"])}
                for tid, ss in traces.items()
            ],
        }

    def close(self) -> None:
        if self._export_fh is not None:
            try:
                self._export_fh.close()
            except OSError:
                pass
            self._export_fh = None


#: export path env override helper for tools; kept trivial on purpose
def default_tracer(service: str) -> Tracer:
    return Tracer(service)


#: records `hot_spans` keeps: a 2 s run of one-object codec calls (30-50 us
#: a call, 3-4 spans each) leaves about 250,000
HOT_RING_SIZE = 1 << 19


class HotSpanRecorder:
    """A bounded ring of (name, parent, start_ns, end_ns) records, stamped
    with `time.perf_counter_ns()`, for span sites on a path too hot for a
    `Span`.

    The `bench_profile` knob switches it, observed into the cached flag
    `on` (the dout-gate idiom): a span site reads the flag and, while it
    is off, does nothing more and allocates nothing:

        if hot_spans.on:
            return hot_spans.call("ec.encode_words", self._encode_words, words)
        return self._encode_words(words)

    On, a span is one tuple appended to a deque: no ids, no dicts, no
    histogram. `parent` is the name of the span that was open when it
    began (None at the top), kept in one slot, so it is right for spans
    opened on one thread at a time. A span whose call raises is recorded
    too. What the records mean (self times, their place on a device
    trace's clock) is left to whoever drains them."""

    __slots__ = ("on", "_ring", "_open")

    def __init__(self, config: Config | None = None,
                 size: int = HOT_RING_SIZE):
        cfg = config if config is not None else global_config
        self.on = bool(cfg.get("bench_profile"))
        self._ring: deque[tuple] = deque(maxlen=max(1, size))
        self._open: str | None = None
        cfg.observe("bench_profile", self._on_profile)

    def _on_profile(self, _n, v) -> None:
        self.on = bool(v)

    def call(self, name: str, fn, *args):
        """fn(*args) inside the span `name`."""
        parent = self._open
        self._open = name
        start = time.perf_counter_ns()
        try:
            return fn(*args)
        finally:
            self._ring.append((name, parent, start, time.perf_counter_ns()))
            self._open = parent

    def drain(self) -> list[tuple]:
        """The records, oldest first (a span after its children), and an
        empty ring."""
        out = list(self._ring)
        self._ring.clear()
        return out

    @staticmethod
    def dump(records: list[tuple]) -> list[dict]:
        """Records as `Span.dump()` dicts of the service "ec_codec", which
        `trace_tool` renders: starts on the wall clock (mapped from
        `perf_counter_ns` through one pair of readings taken now), each
        top-level span a trace of its own, a span's parent the span that
        encloses it."""
        offset = time.time_ns() - time.perf_counter_ns()
        out: list[dict] = []
        stack: list[tuple[str, str, int]] = []  # (span_id, trace_id, end)
        ordered = sorted(records, key=lambda r: (r[2], -r[3]))
        for i, (name, _parent, start, end) in enumerate(ordered, 1):
            while stack and stack[-1][2] < end:
                stack.pop()
            span_id = f"{i:016x}"
            parent_id, trace_id = (stack[-1][0], stack[-1][1]) if stack \
                else (None, span_id)
            stack.append((span_id, trace_id, end))
            out.append({
                "trace_id": trace_id,
                "span_id": span_id,
                "parent_id": parent_id,
                "name": name,
                "service": "ec_codec",
                "start": (start + offset) / 1e9,
                "duration": (end - start) / 1e9,
                "tags": {},
                "events": [],
            })
        return out


#: the process's hot-path recorder: the codec and the kernel wrappers that
#: record into it are module functions that no caller hands a recorder to,
#: as the `.launches` counts beside them are function attributes
hot_spans = HotSpanRecorder()
