"""Dataset operator CLI (the ckpt_tool role for ceph_tpu_torch.data).

    python -m ceph_tpu_torch.tools.data_tool --mon-host 127.0.0.1:6789 --pool 2 <cmd>

Commands:

    ingest <name> --npz file.npz      ingest an .npz's arrays as the
                                      dataset's records (sorted by key;
                                      equal dtype/shape -> tensor schema)
    ls <name>                         committed HEAD + every ingest
                                      present (aborted ingests show
                                      committed=false)
    verify <name> [--ingest-id ID]    fetch + crc-check every record
    iterate <name> [--seed S]         drain one epoch, print per-host
            [--batch-size B]          record counts + iterator perf
            [--num-hosts N] [--host H]
    bench [--mb N] [--record-kb K]    ingest + sustained-read GB/s and
          [--shards N] [--batch-size B]  records/s, one JSON line; reads
                                      run twice — prefetch pipeline on
                                      vs data_prefetch_batches=0 — and
                                      report the speedup + hit rate

Port of the reference package's `tools/data_tool.py`. `--device` (default
cuda, which raises without a card) is where the client's codecs run; `bench`
boots the tools' bench cluster (`tools/bench_cluster.py`: 3 monitors, 6 OSD
daemons on `--device`, a size-3 pool and a k=2 m=2 EC pool) in this
process. Output is JSON per command, like tools/ckpt_tool.py."""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time

from ceph_tpu_torch.device import resolve_device


async def _store(args):
    from ceph_tpu_torch.common.config import Config
    from ceph_tpu_torch.data import DataStore
    from ceph_tpu_torch.mon import MonMap
    from ceph_tpu_torch.rados.client import Rados

    addrs = []
    for hostport in args.mon_host.split(","):
        host, _, port = hostport.rpartition(":")
        addrs.append((host or "127.0.0.1", int(port)))
    rados = Rados(args.name_id, MonMap(addrs=addrs), config=Config(),
                  device=args.device)
    await rados.connect()
    return rados, DataStore(rados.io_ctx(args.pool), args.dataset_name)


def _records_from_npz(path: str) -> list:
    import numpy as np

    with np.load(path) as npz:
        return [np.asarray(npz[k]) for k in sorted(npz.files)]


async def _amain(args) -> int:
    if args.command == "bench":
        result = await _bench(args)
        print(json.dumps(result, sort_keys=True))
        return 0
    rados, store = await _store(args)
    try:
        if args.command == "ingest":
            ingest_id = await store.ingest(_records_from_npz(args.npz))
            result = {"ingest_id": ingest_id, "perf": store.perf_dump()}
        elif args.command == "ls":
            result = await store.ls()
        elif args.command == "verify":
            result = await store.verify(args.ingest_id)
        elif args.command == "iterate":
            it = await store.iterator(
                seed=args.seed, num_hosts=args.num_hosts,
                host=args.host, batch_size=args.batch_size,
            )
            records = batches = 0
            async for batch in it:
                records += len(batch)
                batches += 1
            result = {
                "records": records,
                "batches": batches,
                "perf": store.perf_dump(),
            }
        else:
            raise SystemExit(f"unknown command {args.command!r}")
        print(json.dumps(result, indent=2, sort_keys=True))
        return 0
    finally:
        await rados.shutdown()


async def _drain(store, *, seed: int, batch_size: int):
    """One full epoch; returns (seconds, records, bytes, perf delta)."""
    before = dict(store.perf.dump())
    t0 = time.perf_counter()
    it = await store.iterator(seed=seed, batch_size=batch_size)
    records = 0
    async for batch in it:
        records += len(batch)
    secs = time.perf_counter() - t0
    after = store.perf.dump()
    delta = {
        k: after[k] - before[k]
        for k in ("fetch_bytes", "prefetch_hits", "prefetch_waits")
    }
    return secs, records, delta


async def _bench(args) -> dict:
    """Ingest + sustained-read throughput against an in-process
    cluster, the `bench.py --data` engine. The read runs twice — with
    the prefetch pipeline and with data_prefetch_batches=0 — so the
    line carries its own serial baseline (the >= 2x acceptance bar)."""
    import numpy as np

    from ceph_tpu_torch.data import DataStore
    from ceph_tpu_torch.tools.bench_cluster import EC_POOL, REP_POOL, BenchCluster

    pool = EC_POOL if args.pool_kind == "ec" else REP_POOL
    cluster = await BenchCluster(args.device).start("client.databench")
    rados = cluster.rados
    try:
        total = args.mb * (1 << 20)
        rec_bytes = args.record_kb << 10
        n_records = max(1, total // rec_bytes)
        # size shards so the dataset spans the requested shard count
        cluster.cfg.set(
            "data_shard_bytes", max(4096, total // max(args.shards, 1))
        )
        rng = np.random.default_rng(0)
        records = [
            rng.integers(0, 256, rec_bytes, np.uint8)
            for _ in range(n_records)
        ]
        store = DataStore(rados.io_ctx(pool), "bench-data")
        t0 = time.perf_counter()
        await store.ingest(records)
        t_ingest = time.perf_counter() - t0
        total = n_records * rec_bytes

        prefetch = cluster.cfg.get("data_prefetch_batches")
        read_s, n_read, d = await _drain(
            store, seed=1, batch_size=args.batch_size
        )
        assert n_read == n_records, (n_read, n_records)
        cluster.cfg.set("data_prefetch_batches", 0)
        base_s, n_base, _ = await _drain(
            store, seed=1, batch_size=args.batch_size
        )
        assert n_base == n_records
        cluster.cfg.set("data_prefetch_batches", prefetch)
        asked = d["prefetch_hits"] + d["prefetch_waits"]
        return {
            "bench": "data",
            "device": str(args.device),
            "pool": args.pool_kind,
            "bytes": total,
            "records": n_records,
            "shards": args.shards,
            "ingest_s": round(t_ingest, 6),
            "ingest_gbps": round(total / t_ingest / 1e9, 4),
            "read_s": round(read_s, 6),
            "read_gbps": round(total / read_s / 1e9, 4),
            "records_per_s": round(n_records / read_s, 1),
            "read_noprefetch_s": round(base_s, 6),
            "read_noprefetch_gbps": round(total / base_s / 1e9, 4),
            "prefetch_speedup": round(base_s / max(read_s, 1e-9), 2),
            "prefetch_hit_rate": round(
                d["prefetch_hits"] / max(asked, 1), 4
            ),
        }
    finally:
        await cluster.stop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="data_tool")
    ap.add_argument("--mon-host", default="127.0.0.1:6789")
    ap.add_argument("--pool", type=int, default=1)
    ap.add_argument("--name", dest="name_id", default="client.data")
    ap.add_argument("--npz", default="")
    ap.add_argument("--ingest-id", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--num-hosts", type=int, default=1)
    ap.add_argument("--host", type=int, default=0)
    ap.add_argument("--mb", type=int, default=16)
    ap.add_argument("--record-kb", type=int, default=64)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--pool-kind", choices=("rep", "ec"), default="ec")
    ap.add_argument("--device", default=None,
                    help="where the client's codecs (and bench's daemons) run: "
                         "cuda (default; raises without a card) or cpu")
    ap.add_argument("command",
                    choices=("ingest", "ls", "verify", "iterate",
                             "bench"))
    ap.add_argument("dataset_name", nargs="?", default="dataset")
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)
    return asyncio.run(_amain(args))


if __name__ == "__main__":
    sys.exit(main())
