#!/usr/bin/env python
"""The rados CLI (src/tools/rados analogue): object-level operations
against a live cluster.

    python -m ceph_tpu_torch.tools.rados --mon-host 127.0.0.1:6789 -p <pool> put <obj> <file>
    python -m ceph_tpu_torch.tools.rados --mon-host ... -p <pool> get <obj> <file|->
    python -m ceph_tpu_torch.tools.rados --mon-host ... -p <pool> rm <obj>
    python -m ceph_tpu_torch.tools.rados --mon-host ... -p <pool> stat <obj>
    python -m ceph_tpu_torch.tools.rados --mon-host ... -p <pool> ls
    python -m ceph_tpu_torch.tools.rados --mon-host ... df

`ls` walks every primary's PG inventories over the admin surface (the
pool has no global index; the reference lists via PGLS ops to each PG
primary — same shape). `df` sums per-pool object counts the same way.

Port of the reference package's `tools/rados.py`. `--device` (default cuda,
which raises without a card) is where the client builds its layout codecs.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
from pathlib import Path

from ceph_tpu_torch.device import resolve_device


async def _pool_ls(rados, pool_id: int) -> list[str]:
    """PGLS: ask each up OSD for the objects of this pool's PGs it
    leads (tools/rados `ls` via Objecter::pg_read in the reference)."""
    osdmap = rados.objecter.osdmap
    names: set[str] = set()
    for osd in sorted(osdmap.osd_addrs):
        if osd >= osdmap.max_osd or osdmap.is_down(osd):
            continue
        try:
            rep = await rados.objecter.osd_admin(
                osd, "pg ls", {"pool": pool_id}, timeout=10.0
            )
        # cephlint: disable=error-taxonomy (a down or silent OSD is skipped, as the reference tool skips it; the others list what they lead)
        except Exception:
            continue
        names.update(rep.get("objects", []))
    return sorted(names)


async def _amain(args) -> int:
    from ceph_tpu_torch.common.config import Config
    from ceph_tpu_torch.mon import MonMap
    from ceph_tpu_torch.rados.client import ObjectNotFound, Rados

    addrs = []
    for hostport in args.mon_host.split(","):
        host, _, port = hostport.rpartition(":")
        addrs.append((host or "127.0.0.1", int(port)))
    rados = Rados(args.name, MonMap(addrs=addrs), config=Config(),
                  device=args.device)
    await rados.connect()
    try:
        cmd = args.command
        if cmd == "df":
            osdmap = rados.objecter.osdmap
            out = {}
            for pool_id in sorted(osdmap.pools):
                out[pool_id] = {
                    "objects": len(await _pool_ls(rados, pool_id))
                }
            print(json.dumps(out, indent=2))
            return 0
        if args.pool is None:
            print("-p/--pool required", file=sys.stderr)
            return 2
        io = rados.io_ctx(args.pool)
        if cmd == "put":
            data = await asyncio.to_thread(Path(args.rest[1]).read_bytes)
            await io.write_full(args.rest[0], data)
            return 0
        if cmd == "get":
            data = await io.read(args.rest[0])
            if args.rest[1] == "-":
                sys.stdout.buffer.write(data)
            else:
                await asyncio.to_thread(Path(args.rest[1]).write_bytes, data)
            return 0
        if cmd == "rm":
            await io.remove(args.rest[0])
            return 0
        if cmd == "stat":
            st = await io.stat(args.rest[0])
            print(json.dumps(st, indent=2))
            return 0
        if cmd == "ls":
            for name in await _pool_ls(rados, args.pool):
                print(name)
            return 0
        if cmd == "bench":
            # `rados bench <seconds> write|seq` (src/tools/rados: the
            # operator's quick cluster-throughput probe). write fills
            # benchmark_data-* objects; seq reads them back.
            import time as _time

            seconds = float(args.rest[0]) if args.rest else 5.0
            mode = args.rest[1] if len(args.rest) > 1 else "write"
            size = args.bench_size
            lanes = args.bench_concurrency
            payload = bytes(range(256)) * (size // 256)
            done = {"ops": 0}
            end_at = _time.monotonic() + seconds

            async def writer(lane: int):
                i = 0
                while _time.monotonic() < end_at:
                    await io.write_full(
                        f"benchmark_data-{lane}-{i}", payload
                    )
                    done["ops"] += 1
                    i += 1

            async def reader(lane: int):
                i = 0
                while _time.monotonic() < end_at:
                    try:
                        await io.read(f"benchmark_data-{lane}-{i}")
                    except ObjectNotFound:
                        i = 0
                        continue
                    done["ops"] += 1
                    i += 1

            fn = writer if mode == "write" else reader
            t0 = _time.monotonic()
            await asyncio.gather(*(fn(w) for w in range(lanes)))
            elapsed = max(1e-9, _time.monotonic() - t0)
            print(json.dumps({
                "mode": mode,
                "seconds": round(elapsed, 3),
                "ops": done["ops"],
                "object_size": size,
                "bytes_per_sec": round(done["ops"] * size / elapsed),
                "ops_per_sec": round(done["ops"] / elapsed, 2),
            }, indent=2))
            return 0
        print(f"unknown command {cmd!r}", file=sys.stderr)
        return 2
    except ObjectNotFound as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        await rados.shutdown()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rados")
    ap.add_argument("--mon-host", required=True)
    ap.add_argument("--name", default="client.admin")
    ap.add_argument("-p", "--pool", type=int, default=None)
    ap.add_argument("--bench-size", type=int, default=65536)
    ap.add_argument("--bench-concurrency", type=int, default=8)
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
