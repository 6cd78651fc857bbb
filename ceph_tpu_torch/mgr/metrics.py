"""MetricsModule: the mgr's push-model time-series store + SLO engine.

The reference mgr does not scrape daemons: every daemon's MgrClient
ships a compact perf-counter report to the active mgr on a timer
(src/mgr/MgrClient.cc::_send_report, DaemonServer::handle_report), and
the mgr keeps a bounded per-daemon window of samples
(DaemonPerfCounters::update) from which modules read rates. This module
re-expresses that shape:

- OSDs (and optionally other daemons) send ``mgr_report`` messages every
  ``mgr_report_interval`` seconds carrying *changed* counters only
  (delta-compacted), but with **cumulative** values — a lost report can
  never corrupt a rate, the next sample simply spans a longer interval.
- Per daemon, per counter, the mgr rings the last ``mgr_metrics_window``
  samples. Windowed rates, averages and log2-histogram percentiles are
  derived on demand; nothing is pre-aggregated.
- A declarative SLO rule engine (``mgr_slo_rules``) evaluates counter
  expressions against thresholds and surfaces violations as
  ``MGR_SLO_VIOLATION`` health checks (merged by the mon's ``_health()``),
  Prometheus gauges (``slo_ok`` / ``slo_margin``) and ``GET /api/slo``.

SLO rule grammar (semicolon- or newline-separated)::

    rule      := expr OP threshold [unit] ["@" window_seconds]
    expr      := counter "." agg          # agg: rate|avg|max|p50|p95|p99
               | counter "/" counter      # ratio of windowed deltas
    OP        := "<" | "<=" | ">" | ">="
    unit      := "s" | "ms" | "us"        # threshold scaled to seconds

e.g. ``op_latency.avg < 5ms @ 30; read_redirected/read_balanced < 0.05;
osd_queue_depth.avg < 64``. Units are for seconds-based counters
(TIME_AVG sums); histogram thresholds are in the counter's native unit.
Malformed rules are skipped with a log line, never an exception.

Copy of ceph_tpu/mgr/metrics.py with its imports rewired.
"""

from __future__ import annotations

import re
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

from ceph_tpu_torch.common.config import Config

#: pseudo counter blocks ringing the report's status section; never
#: rendered as perf counters (prometheus skips them)
STATUS_BLOCK = "__status__"
POOL_BLOCK = "__pool__"

_AGGS = ("rate", "avg", "max", "p50", "p95", "p99")

_RULE_RE = re.compile(
    r"^\s*(?P<a>[A-Za-z_]\w*)\s*"
    r"(?:\.\s*(?P<agg>rate|avg|max|p50|p95|p99)"
    r"|/\s*(?P<b>[A-Za-z_]\w*))"
    r"\s*(?P<op><=|>=|<|>)\s*"
    r"(?P<thr>[-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?)\s*"
    r"(?P<unit>s|ms|us)?\s*"
    r"(?:@\s*(?P<win>[0-9]*\.?[0-9]+))?\s*$"
)

_UNIT_SCALE = {None: 1.0, "s": 1.0, "ms": 1e-3, "us": 1e-6}


@dataclass
class SloRule:
    text: str                  # the raw rule, used as its stable name
    counter: str               # numerator / subject counter
    agg: str | None            # rate|avg|max|p50|p95|p99 (None for ratio)
    denominator: str | None    # ratio denominator counter (None for agg)
    op: str                    # < <= > >=
    threshold: float           # already unit-scaled
    window: float | None       # seconds of samples to consider (None=all)


def parse_slo_rules(
    raw: str, on_error: Callable[[str], None] | None = None
) -> list[SloRule]:
    """Parse the ``mgr_slo_rules`` knob; malformed rules are skipped."""
    rules: list[SloRule] = []
    for part in re.split(r"[;\n]", raw or ""):
        text = part.strip()
        if not text:
            continue
        m = _RULE_RE.match(text)
        if m is None:
            if on_error is not None:
                on_error(f"unparseable SLO rule skipped: {text!r}")
            continue
        rules.append(SloRule(
            text=text,
            counter=m.group("a"),
            agg=m.group("agg"),
            denominator=m.group("b"),
            op=m.group("op"),
            threshold=float(m.group("thr")) * _UNIT_SCALE[m.group("unit")],
            window=float(m.group("win")) if m.group("win") else None,
        ))
    return rules


def _compare(op: str, value: float, threshold: float) -> bool:
    if op == "<":
        return value < threshold
    if op == "<=":
        return value <= threshold
    if op == ">":
        return value > threshold
    return value >= threshold


def _total(value: Any) -> float | None:
    """Collapse a sample to a monotone scalar: counters/gauges are
    themselves; TIME_AVG pairs count events; histograms count samples."""
    if isinstance(value, (int, float)):
        return float(value)
    if isinstance(value, dict):
        if "avgcount" in value:
            return float(value["avgcount"])
        try:
            return float(sum(value.values()))
        except TypeError:
            return None
    return None


@dataclass
class _DaemonSeries:
    """One reporting daemon's slice of the store."""
    seq: int = 0
    last_seen: float = 0.0
    #: latest cumulative counter values, merged across delta reports
    latest: dict[str, dict[str, Any]] = field(default_factory=dict)
    #: (block, key) -> ring of (stamp, cumulative value)
    rings: dict[tuple[str, str], deque] = field(default_factory=dict)
    #: last status section verbatim (queue depth, in-flight, pool ops)
    status: dict[str, Any] = field(default_factory=dict)
    #: latest promoted-trace exemplar per latency histogram key
    #: ({trace_id, value, ts}) — rides the Prometheus histograms as
    #: OpenMetrics exemplars when mgr_prometheus_exemplars is on
    exemplars: dict[str, dict[str, Any]] = field(default_factory=dict)


class MetricsModule:
    """Bounded time-series store + SLO engine over daemon push reports."""

    def __init__(self, config: Config | None = None, logger=None):
        self.config = config if config is not None else Config()
        self.daemons: dict[str, _DaemonSeries] = {}
        self._log = logger
        self._rules_raw: str | None = None
        self._rules_cache: list[SloRule] = []

    # -- clock / config --------------------------------------------------------

    @staticmethod
    def _now() -> float:
        return time.monotonic()

    @property
    def window_samples(self) -> int:
        return int(self.config.get("mgr_metrics_window"))

    @property
    def interval(self) -> float:
        return float(self.config.get("mgr_report_interval"))

    def _dout(self, level: int, msg: str) -> None:
        if self._log is not None:
            d = self._log.dout(level)
            if d is not None:
                d(msg)

    # -- ingest ----------------------------------------------------------------

    def reset(self) -> None:
        """Drop all series — a newly-activated mgr must not mix its
        predecessor's baselines with fresh reports (failover reset)."""
        self.daemons.clear()

    def ingest(self, report: dict, now: float | None = None) -> None:
        """Absorb one ``mgr_report`` payload. Unknown daemons (mgr
        failover, daemon restart) re-prime their baseline: the first
        sample opens the ring, rates need a second one, so a rate can
        never be computed across the gap and never goes negative."""
        name = report.get("daemon")
        if not name:
            return
        now = self._now() if now is None else now
        d = self.daemons.get(name)
        if d is None:
            d = self.daemons[name] = _DaemonSeries()
            self._dout(10, f"metrics: priming baseline for {name}")
        d.seq = int(report.get("seq", d.seq + 1))
        d.last_seen = now
        for block, kv in (report.get("counters") or {}).items():
            blk = d.latest.setdefault(block, {})
            for key, val in kv.items():
                prev = blk.get(key)
                blk[key] = val
                self._ring_append(d, block, key, val, prev, now)
        exemplars = report.get("exemplars")
        if exemplars:
            d.exemplars.update(exemplars)
        status = report.get("status")
        if status:
            d.status = status
            for key in ("queue_depth", "inflight_ops"):
                if key in status:
                    self._ring_append(
                        d, STATUS_BLOCK, key, status[key], None, now
                    )
            for pid, cum in (status.get("pool_ops") or {}).items():
                ring = d.rings.get((POOL_BLOCK, str(pid)))
                prev = ring[-1][1] if ring else None
                self._ring_append(d, POOL_BLOCK, str(pid), cum, prev, now)

    def _ring_append(self, d, block, key, val, prev, now) -> None:
        ring = d.rings.get((block, key))
        if ring is None:
            ring = d.rings[(block, key)] = deque(maxlen=self.window_samples)
        if prev is not None:
            pt, vt = _total(prev), _total(val)
            if pt is not None and vt is not None and vt < pt:
                # cumulative went backwards: the daemon restarted under
                # the same name — re-prime rather than emit a negative
                # windowed rate
                ring.clear()
                self._dout(
                    10, f"metrics: counter reset, re-priming {block}/{key}"
                )
        ring.append((now, val))

    def prune(self, now: float | None = None) -> None:
        """Drop daemons silent for far longer than the report tick so a
        decommissioned fleet doesn't pin memory forever."""
        now = self._now() if now is None else now
        horizon = max(30.0, 30 * self.interval)
        for name in [
            n for n, d in self.daemons.items()
            if now - d.last_seen > horizon
        ]:
            del self.daemons[name]

    # -- series access ---------------------------------------------------------

    def fresh_daemons(
        self, now: float | None = None, max_age: float | None = None
    ) -> Iterator[tuple[str, _DaemonSeries]]:
        """Daemons heard from within ``max_age`` (default: the `ceph
        top` age-out of 3 x mgr_report_interval)."""
        now = self._now() if now is None else now
        if max_age is None:
            max_age = 3 * self.interval
        for name in sorted(self.daemons):
            d = self.daemons[name]
            if now - d.last_seen <= max_age:
                yield name, d

    def _find_block(self, d: _DaemonSeries, key: str) -> str | None:
        for block in sorted(d.latest):
            if key in d.latest[block]:
                return block
        if (STATUS_BLOCK, key) in d.rings:
            return STATUS_BLOCK
        return None

    def _samples(
        self, d: _DaemonSeries, block: str, key: str,
        window: float | None, now: float,
    ) -> list[tuple[float, Any]]:
        ring = d.rings.get((block, key))
        if not ring:
            return []
        if window is None:
            return list(ring)
        cutoff = now - window
        return [(t, v) for t, v in ring if t >= cutoff]

    # -- aggregations ----------------------------------------------------------

    def _delta(self, samples) -> float | None:
        """Cumulative growth across the window (first to last sample)."""
        if len(samples) < 2:
            return None
        first, last = _total(samples[0][1]), _total(samples[-1][1])
        if first is None or last is None:
            return None
        return last - first

    def _rate(self, samples) -> float | None:
        if len(samples) < 2:
            return None
        dt = samples[-1][0] - samples[0][0]
        if dt <= 0:
            return None
        dv = self._delta(samples)
        if dv is None:
            return None
        return dv / dt

    @staticmethod
    def _hist_delta(samples) -> dict[int, int] | None:
        """Per-bucket growth of a log2 histogram across the window."""
        if len(samples) < 2:
            return None
        first, last = samples[0][1], samples[-1][1]
        if not isinstance(first, dict) or not isinstance(last, dict):
            return None
        out: dict[int, int] = {}
        for b_str, n in last.items():
            try:
                lower = int(b_str)
            except (TypeError, ValueError):
                return None
            grown = n - first.get(b_str, 0)
            if grown > 0:
                out[lower] = grown
        return out

    @staticmethod
    def _hist_quantile(buckets: dict[int, int], q: float) -> float | None:
        """Estimate the q-quantile from per-bucket counts. Bucket with
        lower bound L holds values in [L, 2L); interpolate linearly
        inside the bucket (the reference renders the same cumulative
        le-bounded shape for prometheus histograms)."""
        total = sum(buckets.values())
        if total <= 0:
            return None
        target = q * total
        seen = 0.0
        for lower in sorted(buckets):
            n = buckets[lower]
            if seen + n >= target:
                frac = (target - seen) / n
                upper = lower * 2 if lower > 0 else 1
                return lower + frac * (upper - lower)
            seen += n
        return float(max(buckets) * 2)

    def _avg(self, samples) -> float | None:
        if not samples:
            return None
        head = samples[-1][1]
        if isinstance(head, (int, float)):
            # gauge: mean of the sampled values
            return sum(v for _, v in samples) / len(samples)
        if isinstance(head, dict) and "avgcount" in head:
            # TIME_AVG: windowed sum/count = mean latency over the window
            if len(samples) < 2:
                return None
            dc = samples[-1][1]["avgcount"] - samples[0][1]["avgcount"]
            ds = samples[-1][1]["sum"] - samples[0][1]["sum"]
            if dc <= 0:
                return None
            return ds / dc
        buckets = self._hist_delta(samples)
        if buckets:
            total = sum(buckets.values())
            mid = sum(
                (low + (low * 2 if low > 0 else 1)) / 2 * n
                for low, n in buckets.items()
            )
            return mid / total
        return None

    def aggregate(
        self, daemon: str, key: str, agg: str,
        window: float | None = None, now: float | None = None,
    ) -> float | None:
        """Compute ``key.agg`` for one daemon; None when not computable
        (unknown counter, too few samples, empty window)."""
        now = self._now() if now is None else now
        d = self.daemons.get(daemon)
        if d is None:
            return None
        block = self._find_block(d, key)
        if block is None:
            return None
        samples = self._samples(d, block, key, window, now)
        if agg == "rate":
            return self._rate(samples)
        if agg == "avg":
            return self._avg(samples)
        if agg == "max":
            vals = [v for _, v in samples if isinstance(v, (int, float))]
            return float(max(vals)) if vals else None
        if agg in ("p50", "p95", "p99"):
            buckets = self._hist_delta(samples)
            if not buckets:
                return None
            return self._hist_quantile(buckets, int(agg[1:]) / 100.0)
        return None

    def ratio(
        self, daemon: str, num: str, den: str,
        window: float | None = None, now: float | None = None,
    ) -> float | None:
        """Windowed delta(num)/delta(den); None when the denominator
        did not move (no traffic => no verdict, not a violation)."""
        now = self._now() if now is None else now
        d = self.daemons.get(daemon)
        if d is None:
            return None
        nb, db = self._find_block(d, num), self._find_block(d, den)
        if nb is None or db is None:
            return None
        dn = self._delta(self._samples(d, nb, num, window, now))
        dd = self._delta(self._samples(d, db, den, window, now))
        if dn is None or not dd:
            return None
        return dn / dd

    # -- SLO engine ------------------------------------------------------------

    def rules(self) -> list[SloRule]:
        raw = self.config.get("mgr_slo_rules") or ""
        if raw != self._rules_raw:
            self._rules_raw = raw
            self._rules_cache = parse_slo_rules(
                raw, on_error=lambda m: self._dout(1, m)
            )
        return self._rules_cache

    def evaluate_slos(self, now: float | None = None) -> list[dict]:
        """Evaluate every rule against every fresh daemon; each result
        carries the worst daemon's value and its relative margin
        (headroom / |threshold|; negative = violated)."""
        now = self._now() if now is None else now
        out: list[dict] = []
        for rule in self.rules():
            worst: tuple[float, str, float] | None = None
            for name, _d in self.fresh_daemons(now):
                if rule.denominator is not None:
                    value = self.ratio(
                        name, rule.counter, rule.denominator,
                        rule.window, now,
                    )
                else:
                    value = self.aggregate(
                        name, rule.counter, rule.agg, rule.window, now
                    )
                if value is None:
                    continue
                if rule.op in ("<", "<="):
                    head = rule.threshold - value
                else:
                    head = value - rule.threshold
                margin = (
                    head / abs(rule.threshold) if rule.threshold else head
                )
                if worst is None or margin < worst[0]:
                    worst = (margin, name, value)
            ok = worst is None or _compare(
                rule.op, worst[2], rule.threshold
            )
            out.append({
                "rule": rule.text,
                "ok": ok,
                "daemon": worst[1] if worst else None,
                "value": worst[2] if worst else None,
                "threshold": rule.threshold,
                "op": rule.op,
                "window": rule.window,
                "margin": worst[0] if worst else None,
            })
        return out

    def recovery_status(self, now: float | None = None) -> dict:
        """Cluster durability debt + healing rate from the metrics
        store: degraded-object counts come from each OSD's status block,
        the objects/s rate from the recovery_pushes/recovery_pulls
        counter series — the feed for PG_DEGRADED / RECOVERY_SLOW and
        the `ceph top` recovery row."""
        now = self._now() if now is None else now
        win = max(4 * self.interval, 2.0)
        degraded = 0
        rate = 0.0
        detail: list[str] = []
        for name, d in self.fresh_daemons(now):
            for key in ("recovery_pushes", "recovery_pulls"):
                r = self.aggregate(name, key, "rate", win, now)
                if r:
                    rate += r
            n = int(d.status.get("degraded_objects") or 0)
            if n:
                degraded += n
                detail.append(f"{name}: {n} object copies degraded")
        return {
            "degraded_objects": degraded,
            "rate": round(rate, 3),
            "detail": detail,
        }

    def health_checks(self, now: float | None = None) -> dict:
        """The health checks the active mgr feeds to the mon (empty
        dict when everything holds — the mon clears on empty):
        MGR_SLO_VIOLATION from the SLO rules, PG_DEGRADED /
        RECOVERY_SLOW from the recovery feed."""
        checks: dict = {}
        rec = self.recovery_status(now)
        if rec["degraded_objects"]:
            checks["PG_DEGRADED"] = {
                "severity": "HEALTH_WARN",
                "summary": (
                    f"{rec['degraded_objects']} object copies degraded,"
                    f" recovering at {rec['rate']:g} obj/s"
                ),
                "count": rec["degraded_objects"],
                "detail": rec["detail"],
            }
            slow = float(
                self.config.get("mgr_recovery_slow_warn") or 0.0
            )
            if slow > 0 and rec["rate"] < slow:
                checks["RECOVERY_SLOW"] = {
                    "severity": "HEALTH_WARN",
                    "summary": (
                        f"recovery at {rec['rate']:g} obj/s, below the"
                        f" {slow:g} obj/s floor with"
                        f" {rec['degraded_objects']} copies degraded"
                    ),
                    "count": 1,
                    "detail": [
                        f"recovery rate {rec['rate']:g} obj/s <"
                        f" mgr_recovery_slow_warn {slow:g}"
                    ],
                }
        violated = [r for r in self.evaluate_slos(now) if not r["ok"]]
        if not violated:
            return checks
        detail = [
            f"rule '{r['rule']}' violated by {r['daemon']}: "
            f"measured {r['value']:.6g} (threshold {r['op']} "
            f"{r['threshold']:g})"
            for r in violated
        ]
        checks["MGR_SLO_VIOLATION"] = {
            "severity": "HEALTH_WARN",
            "summary": (
                f"{len(violated)} SLO rule(s) violated"
            ),
            "count": len(violated),
            "detail": detail,
        }
        return checks

    def slo_document(self, now: float | None = None) -> dict:
        now = self._now() if now is None else now
        results = self.evaluate_slos(now)
        return {
            "rules": results,
            "violated": sum(1 for r in results if not r["ok"]),
            "daemons_reporting": sum(1 for _ in self.fresh_daemons(now)),
        }

    # -- ceph top / prometheus surface ----------------------------------------

    def latest_blocks(
        self, now: float | None = None
    ) -> Iterator[tuple[str, str, dict[str, Any]]]:
        """(daemon, block, counters) for every fresh daemon — the
        store-served replacement for per-scrape ``perf dump`` hops."""
        for name, d in self.fresh_daemons(now):
            for block in sorted(d.latest):
                yield name, block, d.latest[block]

    def exemplar_for(self, daemon: str, key: str) -> dict[str, Any] | None:
        """The latest promoted-trace exemplar a daemon reported for one
        latency histogram key, or None (prometheus exemplar lookup)."""
        d = self.daemons.get(daemon)
        if d is None:
            return None
        return d.exemplars.get(key)

    def series_rates(
        self, window: float | None = None, now: float | None = None
    ) -> Iterator[tuple[str, str, float]]:
        """(block, key, rate/sec) for every countable series of every
        fresh daemon — the `daemon_counter_rate` Prometheus family."""
        now = self._now() if now is None else now
        if window is None:
            window = max(4 * self.interval, 2.0)
        for _name, d in self.fresh_daemons(now):
            for (block, key), _ring in sorted(d.rings.items()):
                if block in (STATUS_BLOCK, POOL_BLOCK):
                    continue
                rate = self._rate(self._samples(d, block, key, window, now))
                if rate is not None:
                    yield block, key, rate

    def _keyed_delta(
        self, d: _DaemonSeries, key: str, window: float | None, now: float
    ) -> float | None:
        block = self._find_block(d, key)
        if block is None:
            return None
        return self._delta(self._samples(d, block, key, window, now))

    def top_document(self, now: float | None = None) -> dict:
        """The `ceph top` payload: per-daemon and per-pool rows over a
        short window, sorted busiest-first. Daemons silent for more
        than 3 x mgr_report_interval have aged out (fresh_daemons)."""
        now = self._now() if now is None else now
        win = max(4 * self.interval, 2.0)

        def r(name: str, key: str) -> float:
            v = self.aggregate(name, key, "rate", win, now)
            return v if v is not None else 0.0

        daemons = []
        pools: dict[str, dict[str, float]] = {}
        for name, d in self.fresh_daemons(now):
            ops = r(name, "op_w") + r(name, "op_r") + r(name, "op_rw")
            totals = {}
            block = self._find_block(d, "op_w")
            if block is not None:
                for key in ("op_w", "op_r", "op_rw"):
                    totals[key] = d.latest[block].get(key, 0)
            hit = self._keyed_delta(d, "buffer_hit", win, now)
            miss = self._keyed_delta(d, "buffer_miss", win, now)
            cache_hit_rate = None
            if hit is not None and miss is not None and hit + miss > 0:
                cache_hit_rate = hit / (hit + miss)
            qd = self.aggregate(name, "osd_queue_depth", "avg", win, now)
            daemons.append({
                "daemon": name,
                "age": round(now - d.last_seen, 3),
                "ops": ops,
                "write_bps": r(name, "op_in_bytes"),
                "read_bps": r(name, "op_out_bytes"),
                "queue_depth": (
                    qd if qd is not None
                    else d.status.get("queue_depth", 0)
                ),
                "inflight": d.status.get("inflight_ops", 0),
                "cache_hit_rate": cache_hit_rate,
                "totals": totals,
            })
            for pid, cum in (d.status.get("pool_ops") or {}).items():
                row = pools.setdefault(
                    str(pid), {"ops": 0.0, "ops_total": 0}
                )
                row["ops_total"] += cum
                prate = self._rate(self._samples(
                    d, POOL_BLOCK, str(pid), win, now
                ))
                if prate:
                    row["ops"] += prate
        daemons.sort(key=lambda row: row["ops"], reverse=True)
        slo = sorted(
            (r for r in self.evaluate_slos(now) if r["margin"] is not None),
            key=lambda r: r["margin"],
        )
        return {
            "window": win,
            "daemons": daemons,
            "pools": [
                {"pool": int(pid), **row}
                for pid, row in sorted(pools.items(), key=lambda x: int(x[0]))
            ],
            "slo": slo,
            "recovery": self.recovery_status(now),
        }
