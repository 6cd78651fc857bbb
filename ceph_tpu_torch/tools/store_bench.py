#!/usr/bin/env python
"""Local object-store microbenchmark: KStore vs BlockStore.

The `ceph daemon osd.N bench` / objectstore fio-plugin role
(src/test/objectstore/store_test.cc perf tier): hammer each ObjectStore
backend directly — no messenger, no PG layer — so the store's own write
and read paths are the only thing on the clock. Reports MB/s per
(backend, workload, object size) over durable FileDB-backed stores, JSON
to stdout (bench.py convention) so CI can diff runs:

    python -m ceph_tpu_torch.tools.store_bench
    python -m ceph_tpu_torch.tools.store_bench --sizes 4096,65536 --bytes-per-case 8388608
    python -m ceph_tpu_torch.tools.store_bench --backend blockstore --out bench.json
    python -m ceph_tpu_torch.tools.store_bench --backend blockstore --buffer-cache-bytes 0

Workloads:

  * `rw` — write every object (fsync-per-transaction, the store's real
    durability cost), read them all back cold-ish, then READ THEM AGAIN:
    the reread pass is the buffer-cache number (BlockStore re-reads skip
    the device and the checksum re-verify; with
    --buffer-cache-bytes 0 they pay full price — the acceptance ratio);
  * `small-write` — sub-min_alloc objects, every write rides the
    deferred (KV WAL) path; the case reports deferred flush counts and
    the peak backlog so the aging/threshold drain is observable, and
    fails loudly if the backlog were unbounded.

BlockStore cases emit the store's own perf counters (onode/buffer cache
hit rates, deferred flush totals) in the JSON and end with a shallow
fsck so a benchmark can never "win" by corrupting itself.

Port of the reference package's `tools/store_bench.py`, over the port's
stores (host-only: no device is involved).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

from ceph_tpu_torch.common.config import Config
from ceph_tpu_torch.common.kv import FileDB
from ceph_tpu_torch.osd.objectstore import KStore, Transaction

COLL = "pg_bench_0"


def _make_config(args) -> Config:
    cfg = Config()
    if args.buffer_cache_bytes is not None:
        cfg.set("blockstore_buffer_cache_bytes", args.buffer_cache_bytes)
    if args.onode_cache_size is not None:
        cfg.set("blockstore_onode_cache_size", args.onode_cache_size)
    if args.deferred_max_age_ms is not None:
        cfg.set("blockstore_deferred_max_age_ms", args.deferred_max_age_ms)
    return cfg


def _make_store(backend: str, path: str, cfg: Config):
    db = FileDB(path)
    if backend == "blockstore":
        from ceph_tpu_torch.osd.blockstore import BlockStore

        return BlockStore(db, config=cfg)
    return KStore(db)


def _close(store) -> None:
    if hasattr(store, "umount"):
        store.umount()
    else:
        store.db.close()


def _store_perf(store) -> dict | None:
    perf = getattr(store, "perf", None)
    if perf is None:
        return None
    d = perf.dump()
    reads = d["buffer_hit"] + d["buffer_miss"]
    onode = d["onode_hit"] + d["onode_miss"]
    return {
        "buffer_hit_rate": d["buffer_hit"] / reads if reads else 0.0,
        "onode_hit_rate": d["onode_hit"] / onode if onode else 0.0,
        "deferred_flushes": d["deferred_flush"],
        "deferred_flushes_aged": d["deferred_flush_aged"],
        "deferred_flush_ops": d["deferred_flush_ops"],
        "deferred_peak_bytes": d["deferred_peak_bytes"],
        "dev_write_calls": d["dev_write_calls"],
        "dev_write_segments": d["dev_write_segments"],
        "dev_read_calls": d["dev_read_calls"],
        "dev_read_segments": d["dev_read_segments"],
    }


def bench_case(backend: str, size: int, bytes_per_case: int,
               base_dir: str, cfg: Config) -> dict:
    count = max(4, bytes_per_case // size)
    payloads = [
        (f"obj-{i:06d}", (i % 251).to_bytes(1, "little") * size)
        for i in range(count)
    ]
    path = os.path.join(base_dir, f"{backend}-rw-{size}")
    store = _make_store(backend, path, cfg)
    store.queue_transaction(Transaction().create_collection(COLL))

    t0 = time.perf_counter()
    for name, data in payloads:
        store.queue_transaction(
            Transaction().write(COLL, name, data, attrs={"ver": 1})
        )
    write_s = time.perf_counter() - t0

    # first read pass: device + checksum verify on a write-cold cache
    # (drop what write-through left behind so `read` is honest about the
    # at-rest integrity tax, as it is for data written before a restart)
    if hasattr(store, "drop_caches"):
        store.drop_caches()
    t0 = time.perf_counter()
    read_bytes = 0
    for name, data in payloads:
        got = store.read(COLL, name)
        read_bytes += len(got)
        assert got == data, f"readback mismatch on {name}"
    read_s = time.perf_counter() - t0

    # reread pass: the buffer-cache hit path (or the same cold path when
    # the cache is disabled — the comparison the acceptance ratio wants)
    t0 = time.perf_counter()
    for name, data in payloads:
        assert store.read(COLL, name) == data
    reread_s = time.perf_counter() - t0

    fsck_errors = None
    if hasattr(store, "fsck"):
        fsck_errors = len(store.fsck())
    perf = _store_perf(store)
    _close(store)
    total = size * count
    return {
        "backend": backend,
        "workload": "rw",
        "object_size": size,
        "objects": count,
        "bytes": total,
        "write_mbps": total / write_s / 1e6,
        "read_mbps": read_bytes / read_s / 1e6,
        "reread_mbps": total / reread_s / 1e6,
        "write_iops": count / write_s,
        "fsck_errors": fsck_errors,
        "perf": perf,
    }


def bench_small_write(backend: str, size: int, bytes_per_case: int,
                      base_dir: str, cfg: Config) -> dict:
    """Sub-min_alloc writes: the deferred/KV-WAL path. Tracks the peak
    backlog so an unbounded queue (a broken drain) is visible."""
    count = max(16, bytes_per_case // 32 // size)
    path = os.path.join(base_dir, f"{backend}-small-{size}")
    store = _make_store(backend, path, cfg)
    store.queue_transaction(Transaction().create_collection(COLL))

    peak_backlog = 0
    t0 = time.perf_counter()
    for i in range(count):
        store.queue_transaction(
            Transaction().write(
                COLL, f"s-{i:06d}", (i % 251).to_bytes(1, "little") * size
            )
        )
        peak_backlog = max(
            peak_backlog, getattr(store, "_deferred_bytes", 0)
        )
    write_s = time.perf_counter() - t0

    # the tail backlog is below the byte threshold: give the AGING
    # flusher its window (this is the observable the acceptance wants —
    # deferred_flushes_aged > 0), falling back to an explicit drain
    max_age = getattr(store, "deferred_max_age", 0)
    if getattr(store, "_deferred_bytes", 0) and max_age > 0:
        deadline = time.perf_counter() + 3 * max_age + 1.0
        while (store._deferred_bytes
               and time.perf_counter() < deadline):
            time.sleep(max_age / 10)
    if hasattr(store, "flush_deferred"):
        store.flush_deferred()
    for i in range(0, count, max(1, count // 64)):
        got = store.read(COLL, f"s-{i:06d}")
        assert got == (i % 251).to_bytes(1, "little") * size
    fsck_errors = len(store.fsck()) if hasattr(store, "fsck") else None
    perf = _store_perf(store)
    _close(store)
    total = size * count
    return {
        "backend": backend,
        "workload": "small-write",
        "object_size": size,
        "objects": count,
        "bytes": total,
        "write_mbps": total / write_s / 1e6,
        "write_iops": count / write_s,
        "peak_deferred_backlog": peak_backlog,
        "fsck_errors": fsck_errors,
        "perf": perf,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="store_bench")
    ap.add_argument("--backends", "--backend", dest="backends",
                    default="kstore,blockstore")
    ap.add_argument("--sizes", default="4096,65536,4194304",
                    help="comma-separated object sizes (bytes)")
    ap.add_argument("--small-sizes", default="512,2048",
                    help="sub-min_alloc sizes for the small-write "
                         "(deferred path) workload; empty disables")
    ap.add_argument("--workloads", default="rw,small-write",
                    help="comma-separated: rw | small-write")
    ap.add_argument("--bytes-per-case", type=int, default=16 << 20,
                    help="approximate bytes written per (backend, size)")
    ap.add_argument("--buffer-cache-bytes", type=int, default=None,
                    help="override blockstore_buffer_cache_bytes "
                         "(0 disables the buffer cache)")
    ap.add_argument("--onode-cache-size", type=int, default=None,
                    help="override blockstore_onode_cache_size")
    ap.add_argument("--deferred-max-age-ms", type=int, default=None,
                    help="override blockstore_deferred_max_age_ms")
    ap.add_argument("--dir", default=None,
                    help="work dir (default: a fresh temp dir, removed)")
    ap.add_argument("--out", default=None, help="also write JSON here")
    args = ap.parse_args(argv)

    cfg = _make_config(args)
    base = args.dir or tempfile.mkdtemp(prefix="store_bench_")
    own_dir = args.dir is None
    workloads = [w.strip() for w in args.workloads.split(",") if w.strip()]
    results = []
    try:
        for backend in (b.strip() for b in args.backends.split(",")):
            if "rw" in workloads:
                for size in (int(s) for s in args.sizes.split(",")):
                    r = bench_case(
                        backend, size, args.bytes_per_case, base, cfg
                    )
                    results.append(r)
                    print(
                        f"# {r['backend']:>10} {r['object_size']:>8}B rw: "
                        f"write {r['write_mbps']:8.1f} MB/s  "
                        f"read {r['read_mbps']:8.1f} MB/s  "
                        f"reread {r['reread_mbps']:8.1f} MB/s",
                        file=sys.stderr,
                    )
            if "small-write" in workloads and args.small_sizes:
                for size in (int(s) for s in args.small_sizes.split(",")):
                    r = bench_small_write(
                        backend, size, args.bytes_per_case, base, cfg
                    )
                    results.append(r)
                    print(
                        f"# {r['backend']:>10} {r['object_size']:>8}B "
                        f"small-write: {r['write_iops']:8.0f} IOPS  "
                        f"peak backlog {r['peak_deferred_backlog']}B",
                        file=sys.stderr,
                    )
    finally:
        if own_dir:
            shutil.rmtree(base, ignore_errors=True)
    doc = {
        "bench": "store_bench",
        "config": {
            "buffer_cache_bytes": args.buffer_cache_bytes,
            "onode_cache_size": args.onode_cache_size,
            "deferred_max_age_ms": args.deferred_max_age_ms,
        },
        "results": results,
    }
    print(json.dumps(doc, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
