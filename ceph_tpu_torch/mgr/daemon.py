"""MgrService: the manager DAEMON (ceph-mgr, src/mgr + MgrMonitor).

The module tier (balancer / autoscaler / prometheus / dashboard) is
hosted by a daemon with a mon-governed identity: every mgr beacons to the mon
(MgrMonitor's beacon flow, the same admit/promote shape as MDS
beacons), exactly one is ACTIVE in the paxos-replicated MgrMap, and
when the active goes silent past mgr_beacon_grace a standby's next
beacon promotes it. Only the active runs module work; a demoted/revived
mgr re-admits as standby.

The mgr also binds its own messenger endpoint: daemons push
perf-counter delta reports to the ACTIVE mgr (MgrClient::_send_report /
DaemonServer::handle_report) on the mgr_report_interval tick. The
beacon advertises the endpoint, the mon publishes it in the MgrMap's
``addrs``, and the MetricsModule rings the samples, evaluates SLO rules
and feeds MGR_SLO_VIOLATION checks back to the mon's health report.

Reference: src/mon/MgrMonitor.cc (map + failover), src/mgr/MgrStandby.cc
(active/standby daemon states), src/mgr/DaemonServer.cc (report
ingestion), src/pybind/mgr (the hosted module tier).

Copy of ceph_tpu/mgr/daemon.py. `MgrService(device=)` (None = cuda, which
raises without a card) is where its client's codecs and the hosted
balancer's batched mapper and move scorer run.
"""

from __future__ import annotations

import asyncio

from ceph_tpu_torch.common.config import Config
from ceph_tpu_torch.common.log import LogRegistry
from ceph_tpu_torch.mgr.metrics import MetricsModule
from ceph_tpu_torch.mgr.traces import TraceCollector
from ceph_tpu_torch.msg.frames import Message, payload_of
from ceph_tpu_torch.msg.messenger import Dispatcher, Messenger
from ceph_tpu_torch.rados.client import Objecter


class _ReportDispatcher(Dispatcher):
    """The mgr endpoint's inbound surface: daemon perf reports plus the
    small `ceph top` command protocol (DaemonServer's MCommand role)."""

    def __init__(self, mgr: "MgrService"):
        self.mgr = mgr

    async def ms_dispatch(self, conn, msg: Message) -> None:
        if msg.type == "mgr_report":
            # a standby must not accumulate series: its store would be
            # stale baselines the moment it promoted — drop, quietly
            if not self.mgr.active:
                if (d := self.mgr.dlog.dout(20)) is not None:
                    d(f"{self.mgr.name} standby: dropping report "
                      f"from {conn.peer_name}")
                return
            report = payload_of(msg)
            self.mgr.metrics.ingest(report)
            self.mgr.traces.ingest(
                report.get("daemon") or conn.peer_name,
                report.get("traces") or [],
            )
            # close the capture loop: a daemon reporting a stale
            # predicate version gets the current set pushed back on the
            # same connection (MgrClient's config-push shape) — no
            # separate subscription channel
            ver = report.get("capture_ver")
            if ver is not None and int(ver) != self.mgr.traces.predicate_version:
                conn.send_message(Message(
                    type="mgr_capture",
                    payload={
                        "ver": self.mgr.traces.predicate_version,
                        "predicates": self.mgr.traces.predicates,
                    },
                ))
            return
        if msg.type == "mgr_command":
            p = payload_of(msg)
            try:
                if not self.mgr.active:
                    raise RuntimeError(f"{self.mgr.name} is standby")
                cmd = p.get("cmd")
                if cmd == "top":
                    result = self.mgr.metrics.top_document()
                    result["traces"] = self.mgr.traces.recent()
                elif cmd == "slo":
                    result = self.mgr.metrics.slo_document()
                elif cmd == "trace ls":
                    result = self.mgr.traces.ls_document()
                elif cmd == "trace show":
                    result = self.mgr.traces.show(p.get("trace_id") or "")
                else:
                    raise RuntimeError(f"unknown mgr command {cmd!r}")
                reply = {"ok": True, "result": result}
            except Exception as e:
                reply = {"ok": False, "error": str(e)}
            conn.send_message(Message(
                type="mgr_command_reply", tid=msg.tid, payload=reply
            ))


class MgrService:
    def __init__(
        self, name: str, monmap, config: Config | None = None,
        keyring: dict[str, bytes] | None = None,
        device=None,
    ):
        self.name = name
        self.config = config if config is not None else Config()
        self.objecter = Objecter(
            name, monmap, config=self.config, keyring=keyring, device=device
        )
        #: the resolved device, handed to the balancer when active
        self.device = self.objecter.device
        self.logs = LogRegistry(self.config)
        self.dlog = self.logs.get_logger("mgr")
        self.active = False
        self._stopped = False
        self._tasks: list[asyncio.Task] = []
        #: lazily built when active: module name -> instance
        self.modules: dict[str, object] = {}
        #: the push-report store + SLO engine; exists while standby too
        #: (so early reports are dropped deliberately, not AttributeError)
        self.metrics = MetricsModule(self.config, logger=self.dlog)
        #: the flight-recorder backend: promoted traces + capture
        #: predicates (same standby-safe lifetime as the metrics store)
        self.traces = TraceCollector(self.config, logger=self.dlog)
        #: our own endpoint: daemons push mgr_report frames here; the
        #: address is advertised through the beacon -> MgrMap
        self.msgr = Messenger(name, config=self.config, keyring=keyring)
        self.msgr.dispatcher = _ReportDispatcher(self)

    async def start(self) -> None:
        await self.msgr.bind()
        await self.objecter.start()
        self._tasks.append(asyncio.create_task(self._beacon_loop()))
        self._tasks.append(asyncio.create_task(self._slo_loop()))

    async def stop(self) -> None:
        self._stopped = True
        if getattr(self, "http", None) is not None:
            await self.http.stop()
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass
        await self.msgr.shutdown()
        await self.objecter.close()

    # -- lifecycle -------------------------------------------------------------

    async def _beacon_loop(self) -> None:
        interval = self.config.get("mgr_beacon_interval")
        while not self._stopped:
            try:
                rep = await self.objecter.mon.command(
                    "mgr beacon",
                    {"name": self.name,
                     "addr": list(self.msgr.my_addr)},
                    timeout=5.0,
                )
                was = self.active
                self.active = (
                    rep["mgrmap"].get("active") == self.name
                )
                if self.active and not was:
                    self._activate()
            # cephlint: disable=error-taxonomy (mon churn: next beacon retries)
            except Exception:
                pass  # mon churn: next beacon retries
            await asyncio.sleep(interval)

    def _activate(self) -> None:
        """Instantiate the module tier (MgrStandby::handle_mgr_map's
        active transition). Modules are plain objects over our objecter;
        operators drive them through this daemon from now on."""
        from ceph_tpu_torch.common.perf_counters import PerfCountersCollection
        from ceph_tpu_torch.mgr.autoscaler import PgAutoscaler
        from ceph_tpu_torch.mgr.balancer import BalancerModule
        from ceph_tpu_torch.mgr.dashboard import DashboardModule
        from ceph_tpu_torch.mgr.prometheus import PrometheusExporter

        # failover baseline reset: whatever partial series a previous
        # active stint (or stray pre-promotion report) left behind must
        # not mix with the fresh full reports daemons send a new active
        self.metrics.reset()
        self.traces.reset()
        balancer = BalancerModule(
            self.objecter.mon,
            tracer=getattr(self.objecter, "tracer", None),
            config=self.config, device=self.device,
        )
        # mgr-local counter blocks (balancer moves/launches/spread) ride
        # the same exporter as the per-daemon perf dumps
        self.perf_collection = PerfCountersCollection()
        self.perf_collection.add(balancer.perf)
        self.modules = {
            "balancer": balancer,
            "pg_autoscaler": PgAutoscaler(self.objecter),
            "metrics": self.metrics,
            "prometheus": PrometheusExporter(
                self.objecter, local_perf=self.perf_collection,
                metrics=self.metrics, config=self.config,
            ),
            "dashboard": DashboardModule(self.objecter),
        }

    async def _slo_loop(self) -> None:
        """The active mgr's health feed: evaluate the SLO rules every
        report tick and ship the (possibly empty) check set to the mon,
        which merges it into `_health()`. An empty report CLEARS a
        previous violation — silence only clears via the mon's
        staleness horizon (mgr died)."""
        while not self._stopped:
            await asyncio.sleep(self.config.get("mgr_report_interval"))
            if not self.active:
                continue
            self.metrics.prune()
            self.traces.prune()
            # refresh the capture-predicate set from the current SLO
            # verdicts; daemons pick the new version up when their next
            # report's capture_ver compares stale
            self.traces.capture_predicates(self.metrics.evaluate_slos())
            checks = self.metrics.health_checks()
            try:
                await self.objecter.mon.command(
                    "mgr health report",
                    {"name": self.name, "checks": checks},
                    timeout=5.0,
                )
            # cephlint: disable=error-taxonomy (mon churn: next tick re-reports)
            except Exception:
                pass  # mon churn: next tick re-reports

    # -- module surface --------------------------------------------------------

    async def prometheus_scrape(self) -> str:
        """The /metrics endpoint body (only the active serves it)."""
        if not self.active:
            raise RuntimeError(f"{self.name} is standby")
        return await self.modules["prometheus"].collect()

    async def serve_http(self, host: str = "127.0.0.1",
                         port: int = 0) -> int:
        """Start the dashboard/metrics HTTP front (dashboard module's
        CherryPy role); serves 503 while standby."""
        from ceph_tpu_torch.mgr.dashboard import DashboardServer

        self.http = DashboardServer(self)
        p = await self.http.start(host, port)
        return p
