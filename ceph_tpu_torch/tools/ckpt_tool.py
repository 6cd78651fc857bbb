"""Checkpoint operator CLI (the rados/orbax-tool role for ceph_tpu_torch.ckpt).

    python -m ceph_tpu_torch.tools.ckpt_tool --mon-host 127.0.0.1:6789 --pool 2 <cmd>

Commands:

    save <name> --npz file.npz        save the arrays of an .npz as one
                                      checkpoint (keys become the pytree)
    restore <name> [--npz out.npz]    restore HEAD (or --save-id) onto
                                      --device and optionally write it
                                      back to .npz
    ls <name>                         committed HEAD + every save present
                                      (aborted saves show committed=false;
                                      per-save dedup ratio and owned-vs-
                                      referenced chunk counts ride along)
    verify <name> [--save-id ID]      fetch + crc-check every chunk
    gc <name> [--keep-last N]         retention + reachability collection
              [--keep-every-nth N]    (chunks any retained manifest
                                      references stay live)
    bench [--mb N] [--arrays K]       save/restore throughput, one JSON
          [--async] [--incremental]   line (GB/s both directions); --async
                                      adds blocking-vs-wall for a
                                      backgrounded second save,
                                      --incremental adds the second-save
                                      dedup ratio

Port of the reference package's `tools/ckpt_tool.py`. `--device` (default
cuda, which raises without a card) is where the client's codecs run and
where `restore` and `bench` place the tensors. `bench` boots its own cluster
in this process (3 monitors, 6 OSD daemons on `--device`, a size-3 pool and
a k=2 m=2 EC pool), as `daemon_bench` does. Output is JSON per command.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time

from ceph_tpu_torch.device import resolve_device
from ceph_tpu_torch.tools.bench_cluster import EC_POOL, REP_POOL, BenchCluster


async def _store(args):
    from ceph_tpu_torch.ckpt import CkptStore
    from ceph_tpu_torch.common.config import Config
    from ceph_tpu_torch.mon import MonMap
    from ceph_tpu_torch.rados.client import Rados

    addrs = []
    for hostport in args.mon_host.split(","):
        host, _, port = hostport.rpartition(":")
        addrs.append((host or "127.0.0.1", int(port)))
    rados = Rados(args.name_id, MonMap(addrs=addrs), config=Config(), device=args.device)
    await rados.connect()
    return rados, CkptStore(rados.io_ctx(args.pool), args.ckpt_name)


def _tree_from_npz(path: str) -> dict:
    import numpy as np

    with np.load(path) as npz:
        return {k: np.asarray(npz[k]) for k in npz.files}


def _tree_to_npz(path: str, tree) -> None:
    import numpy as np
    from torch.utils import _pytree

    from ceph_tpu_torch.ckpt.layout import host_array
    from ceph_tpu_torch.parallel.sharding import MeshArray

    flat = {}
    leaves, _ = _pytree.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, MeshArray))
    for p, leaf in leaves:
        key = "/".join(str(getattr(e, "key", getattr(e, "idx", getattr(e, "name", e))))
                       for e in p) or "value"
        flat[key] = host_array(leaf)
    np.savez(path, **flat)


async def _amain(args) -> int:
    if args.command == "bench":
        result = await _bench(args)
        print(json.dumps(result, sort_keys=True))
        return 0
    rados, store = await _store(args)
    try:
        if args.command == "save":
            tree = _tree_from_npz(args.npz)
            save_id = await store.save(tree)
            result = {"save_id": save_id, "perf": store.perf_dump()}
        elif args.command == "restore":
            tree = await store.restore(save_id=args.save_id, device=args.device)
            if args.npz:
                _tree_to_npz(args.npz, tree)
            result = {
                "restored": sorted(
                    str(k) for k in (tree if isinstance(tree, dict)
                                     else {"value": tree})
                ),
                "perf": store.perf_dump(),
            }
        elif args.command == "ls":
            result = await store.ls()
        elif args.command == "verify":
            result = await store.verify(args.save_id)
        elif args.command == "gc":
            result = await store.gc(
                keep_last=args.keep_last,
                keep_every_nth=args.keep_every_nth,
            )
        else:
            raise SystemExit(f"unknown command {args.command!r}")
        print(json.dumps(result, indent=2, sort_keys=True))
        return 0
    finally:
        await rados.shutdown()


async def _bench(args) -> dict:
    """Save/restore GB/s against an in-process cluster (no external
    daemons needed)."""
    import numpy as np
    import torch

    from ceph_tpu_torch.ckpt import CkptStore

    device = resolve_device(args.device)
    pool = EC_POOL if args.pool_kind == "ec" else REP_POOL
    cluster = await BenchCluster(device).start("client.ckptbench")
    rados = cluster.rados
    try:
        rng = np.random.default_rng(0)
        per = (args.mb * (1 << 20)) // max(args.arrays, 1)

        def leaf():
            return torch.from_numpy(rng.integers(0, 256, per, np.uint8)).to(device)

        def same(back) -> bool:
            return all(torch.equal(back[k], tree[k]) for k in tree)

        tree = {f"w{i}": leaf() for i in range(args.arrays)}
        store = CkptStore(rados.io_ctx(pool), "bench-ckpt")
        total = args.arrays * per
        t0 = time.perf_counter()
        await store.save(tree)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = await store.restore(device=device)
        t_restore = time.perf_counter() - t0
        assert same(back), "restore mismatch"
        result = {
            "bench": "ckpt",
            "device": str(device),
            "pool": args.pool_kind,
            "bytes": total,
            "save_s": round(t_save, 6),
            "restore_s": round(t_restore, 6),
            "save_gbps": round(total / t_save / 1e9, 4),
            "restore_gbps": round(total / t_restore / 1e9, 4),
            "chunks": store.perf.dump()["save_chunks"],
        }

        def mutate():
            """Touch ONE of the K arrays: the unchanged-majority
            second save the async/incremental numbers are defined on."""
            tree["w0"] = leaf()

        if args.bench_incremental or args.bench_async:
            # second save, synchronous: the blocking-time baseline AND
            # the dedup measurement (only changed chunks upload)
            before = dict(store.perf.dump())
            mutate()
            t0 = time.perf_counter()
            sid = await store.save(tree)
            t_second = time.perf_counter() - t0
            after = store.perf.dump()
            reused = after["save_chunks_reused"] - before["save_chunks_reused"]
            uploaded = after["save_chunks"] - before["save_chunks"]
            result.update({
                "second_save_s": round(t_second, 6),
                "chunks_reused": reused,
                "chunks_uploaded": uploaded,
                "dedup_ratio": round(
                    reused / max(reused + uploaded, 1), 4
                ),
            })
            back = await store.restore(save_id=sid, device=device)
            assert same(back), "incremental restore mismatch"
        if args.bench_async:
            # third save, backgrounded: blocking time (the train-
            # visible stall) vs the persist wall time
            mutate()
            t0 = time.perf_counter()
            ps = await store.save_async(tree)
            block_s = time.perf_counter() - t0
            await ps.wait()
            result.update({
                "block_s": round(block_s, 6),
                "wall_s": round(ps.wall_s, 6),
                "blocking_speedup": round(
                    result.get("second_save_s", t_save) / max(block_s, 1e-9), 2
                ),
            })
            back = await store.restore(device=device)
            assert same(back), "async restore mismatch"
        return result
    finally:
        await cluster.stop()


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="ckpt_tool")
    ap.add_argument("--mon-host", default="127.0.0.1:6789")
    ap.add_argument("--pool", type=int, default=1)
    ap.add_argument("--name", dest="name_id", default="client.ckpt")
    ap.add_argument("--npz", default="")
    ap.add_argument("--save-id", default=None)
    ap.add_argument("--mb", type=int, default=16)
    ap.add_argument("--arrays", type=int, default=4)
    ap.add_argument("--pool-kind", choices=("rep", "ec"), default="ec")
    ap.add_argument("--keep-last", type=int, default=None)
    ap.add_argument("--keep-every-nth", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="where the client's codecs run and restored tensors "
                         "land: cuda (default; raises without a card) or cpu")
    ap.add_argument("--async", dest="bench_async", action="store_true",
                    help="bench: blocking-vs-wall of a save_async "
                    "second save")
    ap.add_argument("--incremental", dest="bench_incremental",
                    action="store_true",
                    help="bench: dedup ratio of an unchanged-majority "
                    "second save")
    ap.add_argument("command",
                    choices=("save", "restore", "ls", "verify", "gc",
                             "bench"))
    ap.add_argument("ckpt_name", nargs="?", default="ckpt")
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)
    return args


def main(argv=None) -> int:
    return asyncio.run(_amain(parse_args(argv)))


if __name__ == "__main__":
    sys.exit(main())
