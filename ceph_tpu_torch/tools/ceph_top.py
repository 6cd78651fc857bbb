"""ceph top — live, sorted per-daemon / per-pool cluster activity.

The `ceph top`/`rados top` role: ask the ACTIVE mgr's metrics module
(fed by every daemon's push reports, see ceph_tpu_torch/mgr/metrics.py) for
its top document and render it. No daemon is touched by this tool —
the numbers come straight out of the mgr's time-series store.

    python -m ceph_tpu_torch.tools.ceph_top --mon-host 127.0.0.1:6789 [options]

    --json        emit the raw top document (tests consume this)
    --slo         show SLO rule verdicts instead of the activity table
    --watch N     refresh every N seconds until interrupted
    --sort KEY    daemon sort column: ops (default), write_bps,
                  read_bps, queue_depth, inflight

Columns: ops/s, write/read MB/s, queue depth, in-flight ops (OpTracker),
buffer-cache hit rate, seconds since the daemon's last report. Daemons
silent for more than 3 x mgr_report_interval have aged out server-side.

Port of the reference package's `tools/ceph_top.py`: it touches no device
(the mgr computes the document), so it takes no `--device`.
"""

from __future__ import annotations

import argparse
import asyncio
import itertools
import json
import sys


class TopClient:
    """Thin client for the mgr's report endpoint: resolves the active
    mgr's address from the MgrMap, then drives the tiny
    mgr_command/mgr_command_reply protocol over the messenger."""

    def __init__(self, monmap, config=None, name: str = "client.top"):
        from ceph_tpu_torch.common.config import Config
        from ceph_tpu_torch.mon.client import MonClient
        from ceph_tpu_torch.msg import Dispatcher, Messenger

        self.config = config if config is not None else Config()

        client = self

        class _ReplyCatcher(Dispatcher):
            async def ms_dispatch(self, conn, msg) -> None:
                from ceph_tpu_torch.msg.frames import payload_of

                if msg.type == "mgr_command_reply":
                    fut = client._waiters.pop(msg.tid, None)
                    if fut is not None and not fut.done():
                        fut.set_result(payload_of(msg))

        self._waiters: dict[int, asyncio.Future] = {}
        self._tids = itertools.count(1)
        self.messenger = Messenger(name, config=self.config)
        self.messenger.dispatcher = _ReplyCatcher()
        # MonClient chains itself in front of the catcher and forwards
        # what it doesn't handle — one messenger serves both protocols
        self.mon = MonClient(
            name, monmap, config=self.config, messenger=self.messenger
        )

    async def fetch(self, cmd: str = "top", timeout: float = 10.0,
                    **params) -> dict:
        from ceph_tpu_torch.msg import Message, Policy

        rep = await self.mon.command("mgr map", timeout=timeout)
        mm = rep.get("mgrmap") or {}
        active = mm.get("active")
        addr = (mm.get("addrs") or {}).get(active)
        if not active or not addr:
            raise RuntimeError(
                "no active mgr with an advertised report endpoint "
                f"(mgrmap: {mm})"
            )
        conn = self.messenger.connect(tuple(addr), Policy.lossy_client())
        tid = next(self._tids)
        fut = asyncio.get_event_loop().create_future()
        self._waiters[tid] = fut
        conn.send_message(
            Message(type="mgr_command", tid=tid,
                    payload={"cmd": cmd, **params})
        )
        try:
            reply = await asyncio.wait_for(fut, timeout)
        finally:
            self._waiters.pop(tid, None)
        if not reply.get("ok"):
            raise RuntimeError(f"mgr refused {cmd!r}: {reply.get('error')}")
        return reply["result"]

    async def close(self) -> None:
        await self.messenger.shutdown()


def _fmt_rate(v: float) -> str:
    return f"{v:9.1f}"


def _fmt_mb(v: float) -> str:
    return f"{v / 1e6:8.2f}"


def render_top(doc: dict, sort: str = "ops") -> str:
    lines = [
        f"window {doc.get('window', 0):.1f}s   "
        f"daemons {len(doc.get('daemons', []))}   "
        f"pools {len(doc.get('pools', []))}",
        f"{'NAME':<12} {'OPS/S':>9} {'WR_MB/S':>8} {'RD_MB/S':>8} "
        f"{'QDEPTH':>6} {'INFLT':>5} {'CACHE%':>6} {'AGE':>5}",
    ]
    rows = sorted(
        doc.get("daemons", []),
        key=lambda r: r.get(sort) or 0,
        reverse=True,
    )
    for r in rows:
        hit = r.get("cache_hit_rate")
        lines.append(
            f"{r['daemon']:<12} {_fmt_rate(r['ops'])} "
            f"{_fmt_mb(r['write_bps'])} {_fmt_mb(r['read_bps'])} "
            f"{r['queue_depth']:>6.0f} {r['inflight']:>5} "
            f"{(hit * 100 if hit is not None else 0):>6.1f} "
            f"{r['age']:>5.1f}"
        )
    if doc.get("pools"):
        lines.append("")
        lines.append(f"{'POOL':<6} {'OPS/S':>9} {'OPS_TOTAL':>10}")
        for p in doc["pools"]:
            lines.append(
                f"{p['pool']:<6} {_fmt_rate(p['ops'])} "
                f"{p['ops_total']:>10}"
            )
    rec = doc.get("recovery") or {}
    if rec.get("degraded_objects"):
        lines.append("")
        lines.append(
            f"RECOVERY: {rec['degraded_objects']} object copies "
            f"degraded, healing at {rec.get('rate', 0):g} obj/s"
        )
        for d in rec.get("detail", []):
            lines.append(f"  {d}")
    if doc.get("slo"):
        lines.append("")
        lines.append("SLO (worst margins first):")
        for r in doc["slo"]:
            state = "ok" if r["ok"] else "VIOLATED"
            lines.append(
                f"  [{state:>8}] {r['rule']}  margin "
                f"{r['margin']:+.3f}  worst {r['daemon']} "
                f"= {r['value']:.6g}"
            )
    if doc.get("traces"):
        lines.append("")
        lines.append(
            "TRACES (tail-promoted, newest first — "
            "`ceph trace show <id>` for the span tree):"
        )
        for t in doc["traces"]:
            lines.append(
                f"  {t['trace_id']}  {t.get('reason', '?'):<10} "
                f"{t.get('duration_ms', 0):>9.1f}ms  "
                f"{t.get('num_spans', 0):>3} spans  "
                f"{','.join(t.get('daemons', []))}"
            )
    return "\n".join(lines)


def render_slo(doc: dict) -> str:
    lines = [
        f"{doc.get('daemons_reporting', 0)} daemons reporting, "
        f"{doc.get('violated', 0)} rule(s) violated",
    ]
    for r in doc.get("rules", []):
        state = "ok" if r["ok"] else "VIOLATED"
        val = "n/a" if r["value"] is None else f"{r['value']:.6g}"
        lines.append(
            f"  [{state:>8}] {r['rule']}  measured {val} "
            f"(threshold {r['op']} {r['threshold']:g})"
        )
    return "\n".join(lines)


async def _amain(args) -> int:
    from ceph_tpu_torch.mon import MonMap

    addrs = []
    for hostport in args.mon_host.split(","):
        host, _, port = hostport.rpartition(":")
        addrs.append((host or "127.0.0.1", int(port)))
    client = TopClient(MonMap(addrs=addrs), name=args.name)
    cmd = "slo" if args.slo else "top"
    try:
        while True:
            doc = await client.fetch(cmd, timeout=args.timeout)
            if args.json:
                print(json.dumps(doc, indent=2, sort_keys=True))
            elif args.slo:
                print(render_slo(doc))
            else:
                if args.watch:
                    print("\x1b[2J\x1b[H", end="")
                print(render_top(doc, sort=args.sort))
            if not args.watch:
                return 0
            await asyncio.sleep(args.watch)
    except KeyboardInterrupt:
        return 0
    finally:
        await client.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ceph_top")
    ap.add_argument("--mon-host", required=True,
                    help="comma-separated mon host:port list")
    ap.add_argument("--name", default="client.top")
    ap.add_argument("--json", action="store_true",
                    help="emit the raw top/slo document as JSON")
    ap.add_argument("--slo", action="store_true",
                    help="show SLO verdicts instead of activity")
    ap.add_argument("--watch", type=float, default=0.0,
                    help="refresh every N seconds")
    ap.add_argument("--sort", default="ops",
                    choices=["ops", "write_bps", "read_bps",
                             "queue_depth", "inflight"])
    ap.add_argument("--timeout", type=float, default=10.0)
    args = ap.parse_args(argv)
    return asyncio.run(_amain(args))


if __name__ == "__main__":
    sys.exit(main())
