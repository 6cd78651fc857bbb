"""DashboardModule: the mgr dashboard's API tier (src/pybind/mgr/
dashboard at mini scale — the JSON status surface, not the web UI).

The reference dashboard is a CherryPy app inside ceph-mgr serving
cluster state REST endpoints. Here the same role is an HTTP server the
ACTIVE MgrService hosts:

    GET /api/status    cluster status document (quorum, maps, health,
                       capacity, fsmap/mgrmap) as JSON
    GET /api/df        `ceph df` usage report
    GET /api/health    health checks
    GET /api/slo       the metrics module's SLO rule verdicts
    GET /metrics       the prometheus exporter's scrape text

Standbys refuse with 503 — the failover behavior operators probe.

Copy of ceph_tpu/mgr/dashboard.py with its imports rewired.
"""

from __future__ import annotations

import asyncio
import json


class DashboardModule:
    def __init__(self, objecter):
        self.objecter = objecter

    async def status(self) -> dict:
        # four independent mon round-trips: fan them out concurrently —
        # the document costs the slowest hop, not the sum of the four
        mon = self.objecter.mon
        status, df, fsmap, mgrmap = await asyncio.gather(
            mon.command("status"),
            mon.command("df"),
            mon.command("fs map"),
            mon.command("mgr map"),
        )
        return {
            "cluster": status,
            "df": df,
            "fsmap": fsmap["fsmap"],
            "mgrmap": mgrmap["mgrmap"],
        }


class DashboardServer:
    """Tiny HTTP/1.1 front for the active mgr's modules."""

    def __init__(self, mgr):
        self.mgr = mgr
        self._server: asyncio.AbstractServer | None = None
        self.port: int | None = None

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        self._server = await asyncio.start_server(
            self._serve, host, port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def _serve(self, reader, writer) -> None:
        try:
            line = await reader.readline()
            if not line:
                return
            try:
                method, target, _v = line.decode().strip().split(" ", 2)
            except ValueError:
                return
            while True:  # drain headers
                h = await reader.readline()
                if h in (b"\r\n", b"\n", b""):
                    break
            status, ctype, body = await self._route(method, target)
            writer.write(
                (
                    f"HTTP/1.1 {status} "
                    f"{'OK' if status == 200 else 'ERR'}\r\n"
                    f"Content-Type: {ctype}\r\n"
                    f"Content-Length: {len(body)}\r\n"
                    "Connection: close\r\n\r\n"
                ).encode() + body
            )
            await writer.drain()
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            writer.close()

    async def _route(self, method, target):
        if method != "GET":
            return 405, "text/plain", b"method not allowed"
        if not self.mgr.active:
            # the reference's standby dashboard redirects to the active;
            # the mini surface refuses so probes see the role plainly
            return 503, "text/plain", b"standby mgr"
        try:
            if target.startswith("/api/status"):
                doc = await self.mgr.modules["dashboard"].status()
                return 200, "application/json", json.dumps(
                    doc, default=str
                ).encode()
            if target.startswith("/api/df"):
                df = await self.mgr.objecter.mon.command("df")
                return 200, "application/json", json.dumps(df).encode()
            if target.startswith("/api/health"):
                h = await self.mgr.objecter.mon.command("health")
                return 200, "application/json", json.dumps(h).encode()
            if target.startswith("/api/slo"):
                doc = self.mgr.modules["metrics"].slo_document()
                return 200, "application/json", json.dumps(doc).encode()
            if target.startswith("/metrics"):
                text = await self.mgr.prometheus_scrape()
                # exemplar syntax only exists in OpenMetrics; the
                # Content-Type switches with the knob so 0.0.4-only
                # scrapers are never handed lines they can't parse
                exporter = self.mgr.modules.get("prometheus")
                if exporter is not None and getattr(
                    exporter, "exemplars_enabled", False
                ):
                    ctype = "application/openmetrics-text; version=1.0.0"
                else:
                    ctype = "text/plain; version=0.0.4"
                return 200, ctype, text.encode()
        except Exception as e:  # surface collection errors as 500s
            return 500, "text/plain", str(e).encode()
        return 404, "text/plain", b"not found"
