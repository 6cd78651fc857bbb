"""PrometheusExporter: the cluster's metrics in Prometheus text format.

The reference's mgr prometheus module (src/pybind/mgr/prometheus/
module.py) scrapes every daemon's PerfCounters plus map-level state and
serves /metrics. Same shape here: per-daemon `perf dump` over the admin
surface + OSDMap gauges, rendered as `# TYPE` + labeled samples — a
text-format dump any Prometheus scraper (or the `ceph prometheus` CLI)
can consume.

Counter-type mapping (the module's _perfvalue/_perfhistogram split):
TIME_AVG (avgcount/sum pairs) render as `<name>_sum`/`<name>_count`
sample pairs, HISTOGRAM (log2 bucket counts) as CUMULATIVE
`<name>_bucket{le="..."}` series plus `_count` — so rate() and
histogram_quantile() work on them, instead of flat gauges that lose the
distribution.

With ``mgr_prometheus_exemplars`` on, latency histograms additionally
carry OpenMetrics exemplars: the bucket covering a tail-promoted
trace's duration gets a ``# {trace_id="..."} <value> <ts>`` suffix, so
a dashboard p99 spike links straight to ``ceph trace show <id>``. The
dashboard advertises ``application/openmetrics-text`` for /metrics
when the knob is on (exemplar syntax is OpenMetrics, not the 0.0.4
text format).

Copy of ceph_tpu/mgr/prometheus.py with its imports rewired.
"""

from __future__ import annotations

import asyncio


def _sanitize(name: str) -> str:
    return "".join(c if c.isalnum() else "_" for c in name)


def render_perf_value(emit, key: str, value, labels: dict,
                      exemplar: dict | None = None) -> None:
    """Render one perf-dump counter as Prometheus samples via
    `emit(metric_name, value, labels, type, type_name=None,
    exemplar=None)`.

    Plain ints/floats -> one counter sample. TIME_AVG dicts
    ({avgcount, sum}) -> `_sum` + `_count`. HISTOGRAM dicts (power-of-2
    lower bound -> count) -> cumulative `_bucket{le=...}` + `+Inf` +
    `_count`, the native Prometheus histogram convention. An exemplar
    ({trace_id, value, ts}) attaches to the first histogram bucket
    whose upper edge covers its value (the OpenMetrics rule: an
    exemplar must fall inside its bucket)."""
    if isinstance(value, dict):
        if "avgcount" in value and "sum" in value:
            emit(f"{key}_sum", value["sum"], labels, "counter")
            emit(f"{key}_count", value["avgcount"], labels, "counter")
            return
        try:
            bounds = sorted((int(b), n) for b, n in value.items())
        except (TypeError, ValueError):
            return  # not a perf histogram shape; skip
        total = 0
        placed = exemplar is None
        for lower, n in bounds:
            total += n
            # bucket holds values in [2^b, 2^(b+1)); le is inclusive,
            # so the upper edge for integer samples is 2^(b+1) - 1
            le = 2 * lower - 1
            blab = {**labels, "le": str(le)}
            # the kwarg only appears when there IS an exemplar, so
            # exemplar-unaware emit callbacks keep working
            if not placed and exemplar["value"] <= le:
                placed = True
                emit(f"{key}_bucket", total, blab, "histogram",
                     type_name=key, exemplar=exemplar)
            else:
                emit(f"{key}_bucket", total, blab, "histogram",
                     type_name=key)
        inf_lab = {**labels, "le": "+Inf"}
        if placed:
            emit(f"{key}_bucket", total, inf_lab, "histogram",
                 type_name=key)
        else:
            emit(f"{key}_bucket", total, inf_lab, "histogram",
                 type_name=key, exemplar=exemplar)
        emit(f"{key}_count", total, labels, "histogram",
             type_name=key)
        return
    if isinstance(value, (int, float)):
        emit(key, value, labels, "counter")


class PrometheusExporter:
    #: the reference's metric prefix, kept so a scrape reads the same
    PREFIX = "ceph_tpu"

    def __init__(self, objecter, local_perf=None, metrics=None,
                 config=None):
        self.objecter = objecter
        #: optional PerfCountersCollection of mgr-LOCAL blocks (balancer
        #: moves/launches/spread): scraped in-process, no admin hop
        self.local_perf = local_perf
        #: optional MetricsModule: when daemons push reports, /metrics
        #: is served from the time-series store with NO per-daemon admin
        #: hop on the scrape path (the reference mgr's DaemonStateIndex
        #: role); without it we fall back to pulling perf dumps
        self.metrics = metrics
        self.config = config if config is not None else getattr(
            metrics, "config", None
        )

    @property
    def exemplars_enabled(self) -> bool:
        """OpenMetrics exemplar emission (and the matching /metrics
        Content-Type switch) — off by default: plain-Prometheus
        consumers reject exemplar syntax in the 0.0.4 text format."""
        return bool(
            self.config is not None
            and self.config.get("mgr_prometheus_exemplars")
        )

    async def collect(self) -> str:
        osdmap = self.objecter.osdmap
        lines: list[str] = []
        #: metric name -> already emitted a # TYPE line (the old scan
        #: over `lines` was O(n²) across a large perf dump)
        typed: set[str] = set()

        want_exemplars = self.exemplars_enabled

        def gauge(name: str, value, labels: dict | None = None,
                  mtype: str = "gauge", type_name: str | None = None,
                  exemplar: dict | None = None) -> None:
            full = f"{self.PREFIX}_{_sanitize(name)}"
            # TYPE is declared once per metric FAMILY: histogram series
            # (_bucket/_count) share their base name's declaration
            tname = (
                f"{self.PREFIX}_{_sanitize(type_name)}"
                if type_name is not None else full
            )
            if tname not in typed:
                typed.add(tname)
                lines.append(f"# TYPE {tname} {mtype}")
            lab = ""
            if labels:
                inner = ",".join(
                    f'{k}="{v}"' for k, v in sorted(labels.items())
                )
                lab = "{" + inner + "}"
            tail = ""
            if want_exemplars and exemplar is not None:
                # OpenMetrics exemplar: ` # {labels} value timestamp`
                tail = (
                    f' # {{trace_id="{exemplar["trace_id"]}"}}'
                    f' {exemplar["value"]} {exemplar.get("ts", "")}'
                ).rstrip()
            lines.append(f"{full}{lab} {value}{tail}")

        # health checks (ceph_health_status convention: 0 OK, 1 WARN,
        # 2 ERR; one labeled gauge per active check with its count)
        try:
            health = await self.objecter.mon.command(
                "health", timeout=10.0
            )
        # cephlint: disable=error-taxonomy (mon unreachable: scrape renders without the health section)
        except Exception:
            health = None
        if health is not None:
            level = {"HEALTH_OK": 0, "HEALTH_WARN": 1,
                     "HEALTH_ERR": 2}[health["status"]]
            gauge("health_status", level)
            for name, check in sorted(health["checks"].items()):
                gauge(
                    "health_check", check.get("count", 1),
                    {"check": name,
                     "severity": check["severity"]},
                )

        # map-level gauges (the module's health/df family)
        gauge("osdmap_epoch", osdmap.epoch)
        gauge("osd_up", int(osdmap.max_osd - sum(
            1 for o in range(osdmap.max_osd) if osdmap.is_down(o)
        )))
        gauge("osd_total", int(osdmap.max_osd))
        gauge("pools", len(osdmap.pools))
        for pid, pool in sorted(osdmap.pools.items()):
            gauge("pool_pg_num", pool.pg_num, {"pool": pid})
            gauge("pool_size", pool.size, {"pool": pid})

        # mgr-local module counters (the balancer block): same rendering
        # as daemon counters under the `mgr_` family
        if self.local_perf is not None:
            for logger, counters in sorted(self.local_perf.dump().items()):
                for key, value in sorted(counters.items()):
                    render_perf_value(
                        lambda n, v, lab, t, type_name=None,
                        exemplar=None: gauge(
                            f"mgr_{n}", v, lab, t,
                            type_name=(None if type_name is None
                                       else f"mgr_{type_name}"),
                        ),
                        key, value, {"module": logger},
                    )

        # per-daemon perf counters (TIME_AVG/HISTOGRAM expanded into
        # their native Prometheus representations)
        def emit_daemon(logger: str, counters: dict,
                        daemon: str | None = None) -> None:
            for key, value in sorted(counters.items()):
                ex = None
                if (
                    want_exemplars and daemon is not None
                    and self.metrics is not None
                ):
                    ex = self.metrics.exemplar_for(daemon, key)
                render_perf_value(
                    lambda n, v, lab, t, type_name=None, exemplar=None: gauge(
                        f"daemon_{n}", v, lab, t,
                        type_name=(None if type_name is None
                                   else f"daemon_{type_name}"),
                        exemplar=exemplar,
                    ),
                    key, value, {"daemon": logger}, exemplar=ex,
                )

        served_from_store = False
        if self.metrics is not None:
            blocks = list(self.metrics.latest_blocks())
            if blocks:
                served_from_store = True
                for daemon, block, counters in blocks:
                    emit_daemon(block, counters, daemon=daemon)
                # windowed rates the pull model could never render:
                # first-class per-counter ops/sec series from the ring
                for block, key, rate in self.metrics.series_rates():
                    gauge(
                        "daemon_counter_rate", rate,
                        {"daemon": block, "counter": key},
                    )
                # SLO verdicts: slo_ok 1/0 + relative margin per rule
                for res in self.metrics.evaluate_slos():
                    gauge(
                        "slo_ok", int(bool(res["ok"])),
                        {"rule": res["rule"]},
                    )
                    if res["margin"] is not None:
                        gauge(
                            "slo_margin", res["margin"],
                            {"rule": res["rule"]},
                        )
        if not served_from_store:
            # pull fallback (no reports yet / library use): the admin
            # hops fan out concurrently — scrape latency is the max of
            # the per-daemon round trips, not their sum
            async def pull(osd: int):
                try:
                    return await self.objecter.osd_admin(
                        osd, "perf dump", timeout=10.0
                    )
                # cephlint: disable=error-taxonomy (daemon restarting: skip its counters this scrape)
                except Exception:
                    return None

            live = [
                osd for osd in range(osdmap.max_osd)
                if not osdmap.is_down(osd)
            ]
            dumps = await asyncio.gather(*(pull(osd) for osd in live))
            for dump in dumps:
                if dump is None:
                    continue
                for logger, counters in sorted(dump.items()):
                    emit_daemon(logger, counters)
        return "\n".join(lines) + "\n"
