"""The operator CLI (src/ceph.in analogue): drive a live cluster's mon
quorum and daemons from the shell.

    python -m ceph_tpu_torch.tools.ceph --mon-host 127.0.0.1:6789[,...] <command>

Commands mirror the reference surface:

    status | -s                      cluster status (quorum, epoch, osds)
    df                               cluster + per-osd utilization (incl.
                                     data_compressed / compress_ratio when
                                     blockstore compression is active)
    log last [n]                     tail of the mon cluster log (fence,
                                     read-EIO-repair, slow-request events)
    health                           health checks (OSD_DOWN, PG_DEGRADED,
                                     PG_DAMAGED, ...) with severities
    osd tree                         crush hierarchy with up/down + weights
    osd pool create <id> <rule> [--size N | --profile NAME] [--pg-num N]
    osd erasure-code-profile set <name> k=K m=M [plugin=tpu ...]
    osd down|out|in <osd>
    osd pg-upmap-items <pool.ps> <from:to> [...]
    pg dump [--pool N]               pg -> up/acting/primary
    trace ls | show <id>             tail-promoted traces from the mgr's
                                     flight-recorder store
    balancer run [--pools a,b]       one upmap-balancer pass
    daemon osd.<id> <cmd> [k=v...]   admin socket commands (perf dump,
                                     status, scrub pool=N deep=1, repair
                                     pool=N, dump_ops_in_flight, ...)

Output is JSON per command (the reference's `-f json`).

Port of the reference package's `tools/ceph.py`. `--device` (default cuda,
which raises without a card) is where the client's codecs and the balancer
run."""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys

from ceph_tpu_torch.device import resolve_device


def _parse_kv(pairs):
    out = {}
    for p in pairs:
        k, _, v = p.partition("=")
        out[k] = v
    return out


async def _amain(args) -> int:
    from ceph_tpu_torch.common.config import Config
    from ceph_tpu_torch.mon import MonMap
    from ceph_tpu_torch.rados.client import Rados

    addrs = []
    for hostport in args.mon_host.split(","):
        host, _, port = hostport.rpartition(":")
        addrs.append((host or "127.0.0.1", int(port)))
    monmap = MonMap(addrs=addrs)
    rados = Rados(args.name, monmap, config=Config(), device=args.device)
    await rados.connect()
    try:
        result = await _dispatch(rados, args)
        print(json.dumps(result, indent=2, sort_keys=True))
        return 0
    finally:
        await rados.shutdown()


async def _dispatch(rados, args) -> dict:
    cmd = args.command
    if cmd in ("status", "-s"):
        return await rados.mon_command("status")

    if cmd == "health":
        return await rados.mon_command("health")

    if cmd == "df":
        return await rados.mon_command("df")

    if cmd == "osd":
        sub = args.rest[0]
        if sub == "tree":
            return _osd_tree(rados.objecter.osdmap)
        if sub == "pool" and args.rest[1] == "create":
            pool_id = int(args.rest[2])
            rule = int(args.rest[3])
            payload = {"pool_id": pool_id, "crush_rule": rule}
            if args.profile:
                payload["erasure_code_profile"] = args.profile
            if args.size:
                payload["size"] = args.size
            if args.pg_num:
                payload["pg_num"] = args.pg_num
            return await rados.mon_command("osd pool create", payload)
        if sub == "erasure-code-profile" and args.rest[1] == "set":
            return await rados.mon_command(
                "osd erasure-code-profile set",
                {"name": args.rest[2],
                 "profile": _parse_kv(args.rest[3:])},
            )
        if sub in ("down", "out", "in"):
            return await rados.mon_command(
                f"osd {sub}", {"osd": int(args.rest[1])}
            )
        if sub == "pg-upmap-items":
            mappings = {
                args.rest[1]: [
                    [int(a) for a in pair.split(":")]
                    for pair in args.rest[2:]
                ]
            }
            return await rados.mon_command(
                "osd pg-upmap-items", {"mappings": mappings}
            )
        raise SystemExit(f"unknown osd subcommand {sub!r}")

    if cmd == "config":
        sub = args.rest[0]
        if sub == "set":
            return await rados.mon_command(
                "config set",
                {"name": args.rest[1], "value": args.rest[2]},
            )
        if sub == "get":
            return await rados.mon_command(
                "config get", {"name": args.rest[1]}
            )
        if sub == "rm":
            return await rados.mon_command(
                "config rm", {"name": args.rest[1]}
            )
        if sub == "dump":
            return await rados.mon_command("config dump", {})
        raise SystemExit(f"unknown config subcommand {sub!r}")
    if cmd == "log":
        sub = args.rest[0] if args.rest else "last"
        if sub == "last":
            n = int(args.rest[1]) if len(args.rest) > 1 else 20
            return await rados.mon_command("log last", {"n": n})
        raise SystemExit(f"unknown log subcommand {sub!r}")

    if cmd == "pg" and args.rest[0] == "dump":
        return _pg_dump(rados.objecter.osdmap, args.pool)

    if cmd == "prometheus":
        from ceph_tpu_torch.mgr import PrometheusExporter

        text = await PrometheusExporter(rados.objecter).collect()
        return {"metrics": text}
    if cmd == "autoscaler":
        from ceph_tpu_torch.mgr import PgAutoscaler

        apply = len(args.rest) > 0 and args.rest[0] == "apply"
        return await PgAutoscaler(rados.objecter).run_once(apply=apply)
    if cmd == "balancer" and args.rest[0] == "run":
        from ceph_tpu_torch.mgr import BalancerModule

        pools = (
            {int(p) for p in args.pools.split(",")} if args.pools else None
        )
        return await BalancerModule(
            rados.objecter.mon, device=args.device
        ).run_once(
            pools=pools
        )

    if cmd == "trace":
        # flight-recorder queries answered by the active mgr's trace
        # collector (tail-promoted traces; see ceph_tpu_torch/mgr/traces.py)
        from ceph_tpu_torch.mon import MonMap
        from ceph_tpu_torch.tools.ceph_top import TopClient

        addrs = []
        for hostport in args.mon_host.split(","):
            host, _, port = hostport.rpartition(":")
            addrs.append((host or "127.0.0.1", int(port)))
        top = TopClient(MonMap(addrs=addrs), name=f"{args.name}.trace")
        try:
            sub = args.rest[0] if args.rest else "ls"
            if sub == "ls":
                return await top.fetch("trace ls")
            if sub == "show":
                if len(args.rest) < 2:
                    raise SystemExit("usage: trace show <trace_id>")
                return await top.fetch(
                    "trace show", trace_id=args.rest[1]
                )
            raise SystemExit(f"unknown trace subcommand {sub!r}")
        finally:
            await top.close()

    if cmd == "daemon":
        target = args.rest[0]
        if not target.startswith("osd."):
            raise SystemExit("daemon target must be osd.<id>")
        osd = int(target.split(".", 1)[1])
        admin_cmd = args.rest[1]
        if admin_cmd in ("perf", "dump") and args.rest[1:3] == [
            "perf", "dump"
        ]:
            admin_cmd = "perf dump"
            extra = _parse_kv(args.rest[3:])
        else:
            extra = _parse_kv(args.rest[2:])
        parsed = {
            k: (int(v) if v.isdigit() else v) for k, v in extra.items()
        }
        if "deep" in parsed:
            parsed["deep"] = bool(int(parsed["deep"]))
        return await rados.objecter.osd_admin(osd, admin_cmd, parsed)

    raise SystemExit(f"unknown command {cmd!r}")


def _osd_tree(osdmap) -> dict:
    """`ceph osd tree`: the CrushTreeDumper walk annotated with live
    daemon state (up/down + reweight)."""
    from ceph_tpu_torch.crush.tree import dump_items

    cmap = osdmap.crush
    nodes = []
    for node in dump_items(cmap):
        if node["type"] == "osd":
            osd = node["id"]
            node = {
                **node,
                "status": "up" if osdmap.osd_up[osd] else "down",
                "reweight": float(osdmap.osd_weight[osd]) / 0x10000,
            }
            node.pop("weight", None)
        nodes.append(node)
    return {"nodes": nodes, "epoch": osdmap.epoch}


def _pg_dump(osdmap, pool: int | None) -> dict:
    pgs = []
    for pid, p in sorted(osdmap.pools.items()):
        if pool is not None and pid != pool:
            continue
        for ps in range(p.pg_num):
            up, upp, acting, primary = osdmap.pg_to_up_acting_osds(pid, ps)
            pgs.append({
                "pgid": f"{pid}.{ps}",
                "up": up,
                "acting": acting,
                "primary": primary,
            })
    return {"epoch": osdmap.epoch, "num_pgs": len(pgs), "pgs": pgs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ceph")
    ap.add_argument("--mon-host", required=True,
                    help="comma-separated mon host:port list")
    ap.add_argument("--name", default="client.admin")
    ap.add_argument("--size", type=int, default=0)
    ap.add_argument("--pg-num", type=int, default=0)
    ap.add_argument("--profile", default="")
    ap.add_argument("--pool", type=int, default=None)
    ap.add_argument("--pools", default="")
    ap.add_argument("--device", default=None,
                    help="where the client's codecs run: cuda (default; "
                         "raises without a card) or cpu")
    ap.add_argument("command")
    ap.add_argument("rest", nargs="*")
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)
    return asyncio.run(_amain(args))


if __name__ == "__main__":
    sys.exit(main())
