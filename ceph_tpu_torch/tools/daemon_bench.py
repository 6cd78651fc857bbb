#!/usr/bin/env python
"""daemon_bench: EC write/read throughput through the LIVE daemon path.

Boots real monitors + OSD daemons over real TCP in one process, creates an
EC pool, and drives concurrent client object writes — the full pipeline:
client op -> primary -> batch-encode service (planar GF(2^8) launches on
the daemons' device) -> shard fan-out -> acks. Reports daemon-path GB/s and
the launch-coalescing ratio, as distinct from the raw kernel figure.

Port of the reference package's `tools/daemon_bench.py`: the in-process
run (with `--mgr`, an active manager and its scrape times), `--recovery`
(the recovery engine's A/B: objects healed a second, one object at a time
against batched, on the chaos harness's cluster), `--chaos SEED` (the chaos
harness's live run and its oracle verdict), and `--multiprocess` (every
daemon its own process through `vstart.VStart`, plus `--clients` client
worker processes, each a `--client-worker` run of this module). `--device`
(default cuda, which raises without a card) is where every daemon's codecs
and EncodeService run, in every process: on a card each daemon and worker
holds its own CUDA context.

Usage:
    python -m ceph_tpu_torch.tools.daemon_bench [--osds 6] [--size 262144]
        [--objects 96] [--concurrency 24] [--k 4 --m 2] [--device cpu]
        [--mgr | --recovery [--recovery-objects 400] | --chaos SEED
         | --multiprocess --clients 4]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time
from pathlib import Path

from ceph_tpu_torch.device import resolve_device


def parse_args(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--osds", type=int, default=6)
    ap.add_argument("--size", type=int, default=262144)
    ap.add_argument("--objects", type=int, default=96)
    ap.add_argument("--concurrency", type=int, default=24)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--m", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="where the daemons' codecs run: cuda (default; "
                         "raises without a card) or cpu")
    ap.add_argument("--pool", default="ec", choices=("ec", "rep"),
                    help="pool flavor: ec (k+m profile) or rep "
                         "(3-replica, the balanced-read A/B substrate)")
    ap.add_argument("--read-policy", default="primary",
                    choices=("primary", "balance", "localize"),
                    help="client read policy for the read leg "
                         "(rados_read_policy); balance/localize spread "
                         "reads over clean acting members and take the "
                         "EC direct-shard path")
    ap.add_argument("--hot-set", type=int, default=0,
                    help="read leg hits only the first N objects, "
                         "round-robin (the hot-object shape balanced "
                         "reads exist for); 0 = read back everything "
                         "once")
    # wire fast-path knobs (A/B runs; env CEPH_TPU_MS_* overrides win)
    ap.add_argument("--envelope-format", default=None,
                    choices=("binary", "json"),
                    help="ms_envelope_format for every daemon + client")
    ap.add_argument("--cork-max", type=int, default=None,
                    help="ms_cork_max_frames (1 = no write coalescing)")
    ap.add_argument("--subop-batch", default=None, choices=("on", "off"),
                    help="ms_subop_batch (same-peer sub-op coalescing)")
    ap.add_argument("--stack", default="auto",
                    choices=("tcp", "local", "auto"),
                    help="transport A/B: tcp pins ms_local_stack=false; "
                         "local/auto negotiate the Unix-socket + shm-ring "
                         "LocalStack for the co-located daemons (auto is "
                         "the production default — remote peers still "
                         "fall back to TCP per connection)")
    ap.add_argument("--mgr", action="store_true",
                    help="run an active MgrService during the bench: "
                         "every OSD pushes telemetry reports on "
                         "mgr_report_interval, and the result carries "
                         "push-store vs pull-fallback scrape times "
                         "(the telemetry-overhead A/B substrate)")
    ap.add_argument("--multiprocess", action="store_true",
                    help="every daemon a real OS process (vstart) + "
                         "--clients client worker processes")
    ap.add_argument("--clients", type=int, default=4,
                    help="client worker processes (multiprocess mode)")
    ap.add_argument("--objectstore", default="memstore",
                    choices=("memstore", "kstore-file"),
                    help="OSD store in multiprocess mode; memstore matches "
                         "the single-process bench (MemDB), kstore-file "
                         "adds a per-txn fsync'd WAL")
    ap.add_argument("--run-dir", default=None)
    ap.add_argument("--recovery", action="store_true",
                    help="recovery engine A/B: healed objects/s batched "
                         "vs one-at-a-time, client p99 during the storm")
    ap.add_argument("--recovery-objects", type=int, default=400)
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="run the seeded chaos scenario against a live "
                         "cluster (tools/chaos_tool.py) and report its "
                         "oracle verdict")
    # internal: this invocation is one client worker of a multiprocess run
    ap.add_argument("--client-worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--worker-id", type=int, default=0,
                    help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def read_counts(d: dict) -> dict:
    """The read-serving slice of one OSD's perf dump: who actually
    carried the read leg (primary ops vs balanced replica serves vs EC
    direct-shard ranges), plus bounces."""
    return {
        "op_r": d.get("op_r", 0),
        "read_balanced": d.get("read_balanced", 0),
        "read_shard_direct": d.get("read_shard_direct", 0),
        "read_redirected": d.get("read_redirected", 0),
    }


async def main(args) -> dict:
    from ceph_tpu_torch.common.config import Config
    from ceph_tpu_torch.mon import MonMap, Monitor
    from ceph_tpu_torch.osd import OSDMap
    from ceph_tpu_torch.osd.daemon import OSDService
    from ceph_tpu_torch.rados.client import Rados

    cfg = Config()
    cfg.set("mon_lease", 0.1)
    cfg.set("mon_election_timeout", 0.4)
    cfg.set("osd_heartbeat_interval", 0.5)
    cfg.set("osd_heartbeat_grace", 5)
    if args.envelope_format is not None:
        cfg.set("ms_envelope_format", args.envelope_format)
    if args.cork_max is not None:
        cfg.set("ms_cork_max_frames", args.cork_max)
    if args.subop_batch is not None:
        cfg.set("ms_subop_batch", args.subop_batch == "on")
    if args.stack == "tcp":
        cfg.set("ms_local_stack", False)

    from ceph_tpu_torch.vstart import initial_osdmap

    base = initial_osdmap(args.osds)

    monmap = MonMap(addrs=[("127.0.0.1", 0)] * 3)
    mons = [Monitor(r, monmap, base, config=cfg, device=args.device)
            for r in range(3)]
    for m in mons:
        await m.bind()
    for m in mons:
        m.go()
    osds = {}
    for i in range(args.osds):
        o = OSDService(i, monmap, config=cfg, device=args.device)
        await o.start()
        osds[i] = o

    mgr = None
    if args.mgr:
        from ceph_tpu_torch.mgr import MgrService

        cfg.set("mgr_report_interval", 0.5)
        mgr = MgrService("mgr.bench", monmap, config=cfg, device=args.device)
        await mgr.start()
        deadline = time.monotonic() + 30
        while not mgr.active:
            if time.monotonic() > deadline:
                raise RuntimeError("mgr never went active")
            await asyncio.sleep(0.05)

    rados = Rados("client.bench", monmap, config=cfg, device=args.device)
    await rados.connect()
    if args.pool == "rep":
        await rados.mon_command(
            "osd pool create",
            {"pool_id": 1, "crush_rule": 1, "size": 3, "pg_num": 16},
        )
    else:
        await rados.mon_command(
            "osd erasure-code-profile set",
            {"name": "bench",
             "profile": {"plugin": "tpu", "k": str(args.k),
                         "m": str(args.m)}},
        )
        await rados.mon_command(
            "osd pool create",
            {"pool_id": 1, "crush_rule": 0,
             "erasure_code_profile": "bench", "pg_num": 16},
        )
    io = rados.io_ctx(1)
    if args.read_policy != "primary":
        io.read_policy = args.read_policy
    payload = bytes(range(256)) * (args.size // 256)

    # warm: peering + first-compile of the planar kernel at this shape
    await asyncio.gather(
        *(io.write_full(f"warm-{i}", payload) for i in range(4))
    )

    async def stream(worker: int, count: int):
        for j in range(count):
            await io.write_full(f"o-{worker}-{j}", payload)

    per = max(1, args.objects // args.concurrency)
    before = {
        i: (o.encode_service.launches, o.encode_service.objects)
        for i, o in osds.items()
    }

    def wire_counts() -> dict:
        """Sub-op wire cost across the fleet (frames-per-op source)."""
        tot = {"subop_frames": 0, "subop_ops": 0, "frames_out": 0,
               "bytes_coalesced": 0, "bytes_zero_copy": 0}
        for o in osds.values():
            d = o.perf.dump()
            md = o.messenger.perf.dump()
            tot["subop_frames"] += (
                d.get("subop_direct", 0) + d.get("subop_batch_tx", 0)
            )
            tot["subop_ops"] += (
                d.get("subop_direct", 0) + d.get("subop_batch_tx_ops", 0)
            )
            tot["frames_out"] += md.get("frames_out", 0)
            tot["bytes_coalesced"] += md.get("bytes_coalesced", 0)
            tot["bytes_zero_copy"] += md.get("bytes_zero_copy", 0)
        tot["bytes_zero_copy"] += rados.objecter.messenger.perf.dump().get(
            "bytes_zero_copy", 0
        )
        return tot

    wire0 = wire_counts()
    t0 = time.perf_counter()
    await asyncio.gather(
        *(stream(w, per) for w in range(args.concurrency))
    )
    elapsed = time.perf_counter() - t0
    wire1 = wire_counts()
    n_writes = per * args.concurrency
    wire = {k: wire1[k] - wire0[k] for k in wire0}
    total_bytes = per * args.concurrency * len(payload)
    launches = sum(
        o.encode_service.launches - before[i][0] for i, o in osds.items()
    )
    objects = sum(
        o.encode_service.objects - before[i][1] for i, o in osds.items()
    )

    # read-back leg; with --hot-set the whole leg hammers a few objects
    # (one primary each) — the shape where the read policy matters
    reads0 = {i: read_counts(o.perf.dump()) for i, o in osds.items()}
    t0 = time.perf_counter()
    if args.hot_set:
        hot = [f"o-0-{j % per}" for j in range(args.hot_set)]

        async def stream_hot(w: int):
            for j in range(per):
                await io.read(hot[(w + j) % len(hot)])

        await asyncio.gather(
            *(stream_hot(w) for w in range(args.concurrency))
        )
        read_bytes = per * args.concurrency * len(payload)
    else:
        await asyncio.gather(*(
            io.read(f"o-{w}-{j}")
            for w in range(args.concurrency) for j in range(per)
        ))
        read_bytes = total_bytes
    read_elapsed = time.perf_counter() - t0
    read_dist = {
        i: {
            k: v - reads0[i][k]
            for k, v in read_counts(o.perf.dump()).items()
        }
        for i, o in osds.items()
    }

    # what the client's OSD sessions actually negotiated (the uds->shm
    # upgrade is per connection; "local" means at least one made it)
    client_stacks = {
        c.stack for c in rados.objecter.messenger._conns.values()
    }
    stack_used = (
        "local" if client_stacks & {"uds", "shm"} else "tcp"
    )

    mgr_stats = None
    if mgr is not None:
        from ceph_tpu_torch.mgr.prometheus import PrometheusExporter

        # let every OSD's next push report land in the store
        deadline = time.monotonic() + 20
        while len(mgr.metrics.daemons) < args.osds:
            if time.monotonic() > deadline:
                break
            await asyncio.sleep(0.1)
        t0 = time.perf_counter()
        push_text = await mgr.prometheus_scrape()
        push_ms = (time.perf_counter() - t0) * 1e3
        # the pre-push exporter path: per-scrape `perf dump` admin
        # round-trips to every OSD (what the store replaces)
        puller = PrometheusExporter(rados.objecter)
        t0 = time.perf_counter()
        pull_text = await puller.collect()
        pull_ms = (time.perf_counter() - t0) * 1e3
        mgr_stats = {
            "daemons_reporting": len(mgr.metrics.daemons),
            "scrape_push_ms": round(push_ms, 3),
            "scrape_pull_ms": round(pull_ms, 3),
            "push_series": push_text.count("\n"),
            "pull_series": pull_text.count("\n"),
        }
        await mgr.stop()

    await rados.shutdown()
    for o in osds.values():
        await o.stop()
    for m in mons:
        await m.stop()
    result = {
        "mode": "single-process",
        "ncores": os.cpu_count(),
        "write_gbps": total_bytes / elapsed / 1e9,
        "read_gbps": read_bytes / read_elapsed / 1e9,
        "read_policy": args.read_policy,
        "read_distribution": read_dist,
        "objects": objects,
        "launches": launches,
        "coalescing": objects / max(1, launches),
        "object_size": len(payload),
        "k": args.k,
        "m": args.m,
        "osds": args.osds,
        # sub-op wire frames per client write (fan-out coalescing
        # effectiveness: < k+m means same-peer sub-ops shared frames)
        "frames_per_op": wire["subop_frames"] / max(1, n_writes),
        "subop_frames": wire["subop_frames"],
        "subop_ops": wire["subop_ops"],
        "bytes_coalesced": wire["bytes_coalesced"],
        "stack": stack_used,
        "bytes_zero_copy": wire1["bytes_zero_copy"],
        "envelope_format": str(cfg.get("ms_envelope_format")),
        "cork_max_frames": int(cfg.get("ms_cork_max_frames")),
        "subop_batch": bool(cfg.get("ms_subop_batch")),
    }
    if mgr_stats is not None:
        result["mgr"] = mgr_stats
    return result


async def _recovery_leg(batch_max: int, n_objects: int, device) -> dict:
    """One recovery measurement: amnesiac-kill an OSD, revive it, time
    the heal with `osd_recovery_batch_max` pinned to `batch_max`, with a
    client read loop running throughout (p99 under the storm).  A small
    per-frame wire delay toward the reborn member makes the per-object
    round-trip cost explicit: the serial engine pays it once per object,
    the batched engine once per frame. The pool is the chaos cluster's
    replicated one, so the heal launches no GF(2^8) kernel."""
    from ceph_tpu_torch.tools.chaos_tool import (
        REP_POOL,
        LiveCluster,
        backfill_source,
        chaos_config,
        wait_until,
    )

    cfg = chaos_config()
    cfg.set("osd_recovery_batch_max", batch_max)
    cluster = LiveCluster(cfg, device=device)
    await cluster.start()
    rados = cluster.client("client.rbench")
    await rados.connect()
    await cluster.create_pools(rados)
    io = rados.io_ctx(REP_POOL)
    for i in range(n_objects):
        await io.write_full(f"r{i:04}", bytes([i % 251]) * 2048)

    victim = 0
    await cluster.kill_osd(victim)  # db dropped: amnesiac revival
    await wait_until(
        lambda: all(
            o.osdmap.is_down(victim) for o in cluster.osds.values()
        ),
        timeout=30,
    )
    for i in range(n_objects, n_objects + 16):
        await io.write_full(f"r{i:04}", bytes([i % 251]) * 2048)
    cfg.set("ms_inject_chaos_seed", 1)
    cfg.set(
        "ms_inject_chaos_schedule",
        f"delay:osd.*>osd.{victim}:1:0.05",
    )
    reborn = await cluster.start_osd(victim)
    loop = asyncio.get_event_loop()

    lat: list[float] = []
    stop = asyncio.Event()

    async def client_loop():
        i = 0
        while not stop.is_set():
            s = loop.time()
            await io.read(f"r{i % n_objects:04}")
            lat.append(loop.time() - s)
            i += 1

    reader = asyncio.ensure_future(client_loop())

    # heal target: every object whose PG the victim serves under the
    # settled map must land back on it (amnesiac -> full repopulation)
    await wait_until(
        lambda: all(
            not o.osdmap.is_down(victim)
            for o in cluster.osds.values()
        ),
        timeout=60,
    )
    survivor = cluster.osds[(victim + 1) % (max(cluster.osds) + 1)]
    expected = sum(
        1 for i in range(n_objects + 16)
        if victim in survivor.acting_of(
            REP_POOL,
            survivor.object_pg(REP_POOL, f"r{i:04}"),
        )[0]
    )

    def healed_count() -> int:
        n = 0
        for coll in reborn.store.list_collections():
            n += len([
                o for o in reborn.store.list_objects(coll)
                if not o.startswith(".")
            ])
        return n

    def healed() -> bool:
        return healed_count() >= expected and (
            backfill_source(cluster) is None
        )

    # clock the push phase itself: start at the first landed object so
    # peering/up-mark latency (identical in both legs) cancels out
    await wait_until(lambda: healed_count() > 0, timeout=60)
    base = healed_count()
    t0 = loop.time()
    await wait_until(healed, timeout=300)
    heal_seconds = max(1e-9, loop.time() - t0)
    healed_objects = healed_count() - base
    stop.set()
    await reader
    cfg.set("ms_inject_chaos_schedule", "")
    p99 = sorted(lat)[int(len(lat) * 0.99)] if lat else 0.0
    await rados.shutdown()
    await cluster.stop()
    return {
        "batch_max": batch_max,
        "healed_objects": healed_objects,
        "heal_seconds": round(heal_seconds, 3),
        "healed_obj_per_s": round(healed_objects / heal_seconds, 2),
        "client_ops": len(lat),
        "client_p99_s": round(p99, 4),
    }


async def main_recovery(args) -> dict:
    """A/B: one-object-at-a-time (batch_max=1) vs the batched engine."""
    from ceph_tpu_torch.common.config import Config

    serial = await _recovery_leg(1, args.recovery_objects, args.device)
    batch = int(Config().get("osd_recovery_batch_max"))
    batched = await _recovery_leg(batch, args.recovery_objects, args.device)
    return {
        "mode": "recovery",
        "objects": args.recovery_objects,
        "serial": serial,
        "batched": batched,
        "speedup": round(
            batched["healed_obj_per_s"]
            / max(1e-9, serial["healed_obj_per_s"]), 2,
        ),
    }


async def main_chaos(args) -> dict:
    from ceph_tpu_torch.tools.chaos_tool import run_chaos_live

    report = await run_chaos_live(
        args.chaos, steps=8, step_seconds=1.5,
        progress=lambda *_: None, device=args.device,
    )
    report["mode"] = "chaos"
    return report



async def client_worker(args) -> dict:
    """One client process of a multiprocess run: write then read its own
    object range against the already-created pool, report wall windows."""
    from ceph_tpu_torch.rados.client import Rados
    from ceph_tpu_torch.vstart import ClusterSpec

    spec = ClusterSpec.load(args.client_worker)
    rados = Rados(
        f"client.bench{args.worker_id}", spec.monmap(),
        config=spec.build_config(), device=args.device,
    )
    await rados.connect()
    io = rados.io_ctx(1)
    if args.read_policy != "primary":
        io.read_policy = args.read_policy
    payload = bytes(range(256)) * (args.size // 256)
    names = [
        f"o-{args.worker_id}-{j}" for j in range(args.objects)
    ]

    async def stream(chunk):
        for name in chunk:
            await io.write_full(name, payload)

    lanes = max(1, args.concurrency)
    chunks = [names[i::lanes] for i in range(lanes)]
    w0 = time.time()
    await asyncio.gather(*(stream(c) for c in chunks))
    w1 = time.time()

    # hot-set reads hit worker 0's objects so EVERY client process
    # contends on the same few primaries under policy=primary; they wait
    # until every worker has written (a worker that started late would
    # otherwise be read before it wrote)
    if args.hot_set:
        wrote = os.path.join(spec.run_dir, "bench-wrote.{}")
        await asyncio.to_thread(Path(wrote.format(args.worker_id)).touch)
        while not all(os.path.exists(wrote.format(w)) for w in range(args.clients)):
            await asyncio.sleep(0.05)
        rnames = [
            f"o-0-{j % args.objects}" for j in range(args.hot_set)
        ]
        reads = [
            rnames[(args.worker_id + j) % len(rnames)]
            for j in range(args.objects)
        ]
    else:
        reads = names

    async def stream_r(chunk):
        for name in chunk:
            if await io.read(name) != payload:
                raise AssertionError(f"{name}: read back differs")

    rchunks = [reads[i::lanes] for i in range(lanes)]
    r0 = time.time()
    await asyncio.gather(*(stream_r(c) for c in rchunks))
    r1 = time.time()
    await rados.shutdown()
    return {
        "bytes": len(payload) * len(names),
        "read_bytes": len(payload) * len(reads),
        "write_window": [w0, w1],
        "read_window": [r0, r1],
    }


async def main_multiprocess(args) -> dict:
    """N OSD processes + C client processes, no shared interpreter
    anywhere on the data path; every one of them on `args.device`."""
    import subprocess
    import tempfile

    from ceph_tpu_torch.vstart import VStart

    run_dir = args.run_dir or tempfile.mkdtemp(prefix="daemon-bench-")
    # builds the device's kernels before any daemon or worker starts
    v = VStart(
        run_dir, n_mons=3, n_osds=args.osds,
        config={"osd_objectstore": args.objectstore},
        device=args.device,
    )
    v.start()
    procs = []
    try:
        # every daemon past its boot (interpreter, CUDA context) first
        await asyncio.to_thread(v.wait_started, 300)
        rados = v.client()
        await rados.connect()
        await v.wait_healthy(rados=rados, timeout=120)
        if args.pool == "rep":
            await rados.mon_command(
                "osd pool create",
                {"pool_id": 1, "crush_rule": 1, "size": 3,
                 "pg_num": 32},
            )
        else:
            await rados.mon_command(
                "osd erasure-code-profile set",
                {"name": "bench",
                 "profile": {"plugin": "tpu", "k": str(args.k),
                             "m": str(args.m)}},
            )
            await rados.mon_command(
                "osd pool create",
                {"pool_id": 1, "crush_rule": 0,
                 "erasure_code_profile": "bench", "pg_num": 32},
            )
        io = rados.io_ctx(1)
        payload = bytes(range(256)) * (args.size // 256)
        # warm: peering + each OSD's first launch at this shape
        for i in range(2 * args.osds):
            await io.write_full(f"warm-{i}", payload)

        async def fleet_reads() -> dict:
            out = {}
            for osd in range(args.osds):
                dump = await rados.objecter.osd_admin(osd, "perf dump")
                out[osd] = read_counts(dump.get(f"osd.{osd}", {}))
            return out

        # write legs never touch the read counters, so the pre-spawn
        # snapshot isolates the workers' read legs exactly
        reads0 = await fleet_reads()

        per_client = max(1, args.objects // args.clients)
        lanes = max(1, args.concurrency // args.clients)
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", "ceph_tpu_torch.tools.daemon_bench",
                 "--client-worker", v.spec_path,
                 "--worker-id", str(w),
                 "--clients", str(args.clients),
                 "--objects", str(per_client),
                 "--size", str(args.size),
                 "--concurrency", str(lanes),
                 "--read-policy", args.read_policy,
                 "--hot-set", str(args.hot_set),
                 "--device", str(args.device)],
                stdout=subprocess.PIPE, env=v.env,
                cwd=os.path.dirname(os.path.dirname(os.path.dirname(
                    os.path.abspath(__file__)))),
            )
            for w in range(args.clients)
        ]
        # the workers run while this loop idles: wait for them off it
        raw_outs = await asyncio.gather(*(
            asyncio.to_thread(p.communicate, timeout=600) for p in procs
        ))
        for p in procs:
            if p.returncode:
                raise RuntimeError(
                    f"client worker pid {p.pid} failed "
                    f"(rc={p.returncode})"
                )
        outs = [json.loads(o[0]) for o in raw_outs]
        reads1 = await fleet_reads()
        read_dist = {
            osd: {k: reads1[osd][k] - reads0[osd][k]
                  for k in reads1[osd]}
            for osd in reads1
        }
        await rados.shutdown()
        total = sum(o["bytes"] for o in outs)
        read_total = sum(o.get("read_bytes", o["bytes"]) for o in outs)
        w_span = max(o["write_window"][1] for o in outs) - min(
            o["write_window"][0] for o in outs
        )
        r_span = max(o["read_window"][1] for o in outs) - min(
            o["read_window"][0] for o in outs
        )
        return {
            "mode": "multiprocess",
            "ncores": os.cpu_count(),
            "write_gbps": total / w_span / 1e9,
            "read_gbps": read_total / r_span / 1e9,
            "read_policy": args.read_policy,
            "read_distribution": read_dist,
            "object_size": args.size,
            "objects": per_client * args.clients,
            "k": args.k,
            "m": args.m,
            "osds": args.osds,
            "clients": args.clients,
        }
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        v.stop()


def run(argv: list[str] | None = None) -> dict:
    """Parse `argv`, run the bench (or one client worker), return its
    result dict."""
    args = parse_args(argv)
    args.device = resolve_device(args.device)
    if args.client_worker:
        return asyncio.run(asyncio.wait_for(client_worker(args), 600))
    if args.chaos is not None:
        return asyncio.run(asyncio.wait_for(main_chaos(args), 900))
    if args.recovery:
        return asyncio.run(asyncio.wait_for(main_recovery(args), 900))
    if args.multiprocess:
        return asyncio.run(asyncio.wait_for(main_multiprocess(args), 900))
    return asyncio.run(asyncio.wait_for(main(args), 600))


if __name__ == "__main__":
    result = run()
    json.dump({k: (round(v, 3) if isinstance(v, float) else v)
               for k, v in result.items()}, sys.stdout)
    print()
