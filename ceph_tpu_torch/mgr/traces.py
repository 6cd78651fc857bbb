"""TraceCollector: the mgr's store for tail-promoted traces.

The flight-recorder pipeline's terminal stage: daemons promote a trace
at op completion (slow / errored / SLO-capture / slowest-N — see
common/tracer.py) and ship the gathered spans on their next
``mgr_report`` tick. The active mgr merges every daemon's fragment of
the same trace here — spans are deduped by span_id, so the client's
relayed spans and the primary OSD's own flight spans assemble into one
cross-daemon tree — and serves them back through ``ceph trace ls`` /
``ceph trace show <id>``. The same ids ride the Prometheus latency
histograms as OpenMetrics exemplars and the `ceph top` TRACES pane, so
a p99 spike is one command away from its span timeline.

The store is deliberately small and self-cleaning: at most
``mgr_trace_store_max`` traces (oldest-promoted evicted first) and
nothing older than ``mgr_trace_ttl`` seconds survives ``prune()`` —
this is a flight recorder, not a trace warehouse; Jaeger-shaped
retention stays in ``tracer_export_path`` + tools/trace_tool.py.

The collector also closes the capture loop: ``capture_predicates()``
derives per-rule {name, min_ms} predicates from the SLO engine's
currently-violated rules, and the report dispatcher pushes them to any
daemon whose reported ``capture_ver`` is stale — while a latency SLO
burns, every daemon keeps a budgeted quota of matching traces that
head sampling would have dropped.

Copy of ceph_tpu/mgr/traces.py with its imports rewired.
"""

from __future__ import annotations

import re
import time
from typing import Any

from ceph_tpu_torch.common.config import Config


class TraceCollector:
    """Bounded, TTL-aged store of promoted traces, merged across
    daemons (the Canopy backend role, scaled to a flight recorder)."""

    def __init__(self, config: Config | None = None, logger=None):
        self.config = config if config is not None else Config()
        self._log = logger
        #: trace_id -> entry; insertion order = promotion arrival order
        #: (Python dict ordering is the eviction queue)
        self._traces: dict[str, dict[str, Any]] = {}
        #: version stamped on the current predicate set; bumped only
        #: when the set actually changes so daemons aren't re-pushed
        #: an identical list every report
        self._pred_ver = 0
        self._pred_cache: list[dict] = []

    # -- config ----------------------------------------------------------------

    @property
    def store_max(self) -> int:
        return int(self.config.get("mgr_trace_store_max"))

    @property
    def ttl(self) -> float:
        return float(self.config.get("mgr_trace_ttl"))

    def _dout(self, level: int, msg: str) -> None:
        if self._log is not None:
            d = self._log.dout(level)
            if d is not None:
                d(msg)

    # -- ingest ----------------------------------------------------------------

    def reset(self) -> None:
        """Failover reset: a newly-activated mgr starts empty (same
        contract as MetricsModule.reset — stale trace fragments from a
        previous active stint must not merge with fresh reports)."""
        self._traces.clear()
        self._pred_ver = 0
        self._pred_cache = []

    def ingest(self, daemon: str, promoted: list[dict],
               now: float | None = None) -> None:
        """Absorb one report's promoted-trace list. Fragments of a
        trace already held (the client relay and the primary both
        reported it, or a straggler span arrived a tick later) merge
        by span_id instead of duplicating."""
        if not promoted:
            return
        now = time.time() if now is None else now
        for item in promoted:
            if not isinstance(item, dict):
                continue
            tid = item.get("trace_id")
            if not tid:
                continue
            entry = self._traces.get(tid)
            if entry is None:
                entry = self._traces[tid] = {
                    "trace_id": tid,
                    "reason": item.get("reason") or "unknown",
                    "first_seen": now,
                    "daemons": [],
                    "spans": {},
                }
                self._dout(
                    10,
                    f"traces: promoted {tid} ({entry['reason']}) "
                    f"from {daemon}",
                )
            entry["last_seen"] = now
            if daemon not in entry["daemons"]:
                entry["daemons"].append(daemon)
            spans = entry["spans"]
            for s in item.get("spans") or []:
                sid = isinstance(s, dict) and s.get("span_id")
                if sid and sid not in spans:
                    spans[sid] = s
            root = item.get("root")
            if isinstance(root, dict) and root.get("span_id"):
                spans.setdefault(root["span_id"], root)
            while len(self._traces) > self.store_max:
                self._traces.pop(next(iter(self._traces)))

    def prune(self, now: float | None = None) -> None:
        """TTL age-out on the mgr's periodic tick: a flight recorder
        holds the recent past, not history."""
        ttl = self.ttl
        if ttl <= 0:
            return
        now = time.time() if now is None else now
        for tid in [
            t for t, e in self._traces.items()
            if now - e.get("last_seen", now) > ttl
        ]:
            del self._traces[tid]

    # -- query surface (ceph trace ls / show) ----------------------------------

    def __len__(self) -> int:
        return len(self._traces)

    def _summary(self, entry: dict) -> dict:
        spans = entry["spans"].values()
        # the trace's wall duration from its spans: earliest start to
        # latest end (fragments may arrive without the root)
        start = min((s.get("start") or 0.0 for s in spans), default=0.0)
        end = max(
            ((s.get("start") or 0.0) + (s.get("duration") or 0.0)
             for s in spans),
            default=0.0,
        )
        root = next(
            (s for s in spans if not s.get("parent_id")), None
        )
        return {
            "trace_id": entry["trace_id"],
            "reason": entry["reason"],
            "root": (root or {}).get("name"),
            "duration_ms": round(max(0.0, end - start) * 1e3, 3),
            "num_spans": len(entry["spans"]),
            "daemons": list(entry["daemons"]),
            "age": round(time.time() - entry["first_seen"], 1),
        }

    def ls_document(self) -> dict:
        """`ceph trace ls`: newest promotions first."""
        rows = [
            self._summary(e) for e in reversed(list(self._traces.values()))
        ]
        return {"num_traces": len(rows), "traces": rows}

    def show(self, trace_id: str) -> dict:
        """`ceph trace show <id>`: the merged span tree, oldest span
        first — the same span-dump shape trace_tool renders."""
        entry = self._traces.get(trace_id)
        if entry is None:
            raise KeyError(f"no such trace {trace_id!r} (aged out?)")
        spans = sorted(
            entry["spans"].values(), key=lambda s: s.get("start") or 0.0
        )
        return {**self._summary(entry), "spans": spans}

    def recent(self, limit: int = 5) -> list[dict]:
        """Newest promoted-trace summaries — the `ceph top` TRACES
        drill-down pane."""
        rows = []
        for e in reversed(list(self._traces.values())):
            rows.append(self._summary(e))
            if len(rows) >= limit:
                break
        return rows

    # -- capture predicates ----------------------------------------------------

    def capture_predicates(self, slo_results: list[dict]) -> tuple[int, list]:
        """(version, predicates) derived from the SLO engine's current
        verdicts: every VIOLATED rule becomes a capture predicate the
        daemons match at op completion. Latency-shaped rules (`<`/`<=`
        thresholds, i.e. "should stay below") pre-filter by min_ms =
        threshold in ms so a daemon only spends capture budget on ops
        that actually breach; other shapes capture unfiltered (min_ms
        0) — the point is a sample of traffic while the rule burns."""
        preds = []
        for r in slo_results:
            if r.get("ok"):
                continue
            name = r.get("rule") or "slo"
            min_ms = 0.0
            thr = r.get("threshold")
            if (
                r.get("op") in ("<", "<=")
                and isinstance(thr, (int, float)) and thr > 0
            ):
                # "stay below" rules pre-filter by the threshold so a
                # daemon only spends capture budget on ops that breach.
                # The threshold's unit depends on the rule shape:
                # lat_us_* histogram rules are native µs, unit-suffixed
                # rules were parser-scaled to seconds, anything else
                # (ratios, counts) is not a latency — capture a
                # traffic sample unfiltered.
                counter = re.match(r"\s*([A-Za-z_]\w*)", name)
                cname = counter.group(1) if counter else ""
                if "_us" in cname:
                    min_ms = float(thr) / 1e3
                elif re.search(r"\d\s*(?:ms|us|s)\b", name):
                    min_ms = float(thr) * 1e3
            preds.append({"name": name, "min_ms": min_ms})
        preds.sort(key=lambda p: p["name"])
        if preds != self._pred_cache:
            self._pred_cache = preds
            self._pred_ver += 1
            self._dout(
                4,
                f"traces: capture predicates v{self._pred_ver}: "
                f"{[p['name'] for p in preds]}",
            )
        return self._pred_ver, list(self._pred_cache)

    @property
    def predicate_version(self) -> int:
        return self._pred_ver

    @property
    def predicates(self) -> list[dict]:
        return list(self._pred_cache)
