#!/usr/bin/env python
"""ceph-objectstore-tool analogue: OFFLINE surgery on an OSD's store.

Operates directly on a stopped OSD's durable store (the FileDB
directory; KStore or BlockStore, autodetected like the reference probes
the store type from the data dir), the way the reference tool opens a
stopped OSD's BlueStore/FileStore (src/tools/ceph_objectstore_tool.cc):

    python -m ceph_tpu_torch.tools.objectstore_tool --data-path <dir> --op list
    python -m ceph_tpu_torch.tools.objectstore_tool --data-path <dir> --op list --pgid 2.3
    python -m ceph_tpu_torch.tools.objectstore_tool --data-path <dir> --op info \
        --pgid 2.3 --obj <name>
    python -m ceph_tpu_torch.tools.objectstore_tool --data-path <dir> --op get \
        --pgid 2.3 --obj <name> --out <file>
    python -m ceph_tpu_torch.tools.objectstore_tool --data-path <dir> --op export \
        --pgid 2.3 --out <file>
    python -m ceph_tpu_torch.tools.objectstore_tool --data-path <dir> --op import \
        --file <file>
    python -m ceph_tpu_torch.tools.objectstore_tool --data-path <dir> --op log --pgid 2.3
    python -m ceph_tpu_torch.tools.objectstore_tool --data-path <dir> --op fsck [--deep]

export/import move one PG's complete contents (objects + attrs + omap +
the pg-meta log) between stores as a JSON bundle — the disaster-recovery
flow the reference tool exists for (yank a PG off a dead OSD's disk,
inject it into a fresh one); the bundle is store-agnostic, so a PG
exported from a KStore OSD imports into a BlockStore OSD and vice versa.
`--op fsck` runs the store's own consistency check (`--deep` re-reads
every blob against its at-rest checksums on BlockStore) and exits
nonzero when errors are found, like `ceph-objectstore-tool --op fsck`.

Port of the reference package's `tools/objectstore_tool.py`, over the
port's KStore and BlockStore; its output equals the reference tool's on the
same store.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import sys

from ceph_tpu_torch.common.kv import FileDB
from ceph_tpu_torch.osd.objectstore import (
    KStore,
    StoreError,
    Transaction,
)

PGMETA = ".pgmeta"


def _b64(b: bytes) -> str:
    return base64.b64encode(b).decode()


def _unb64(s: str) -> bytes:
    return base64.b64decode(s)


def _attrs_jsonable(attrs: dict) -> dict:
    from ceph_tpu_torch.osd.ecutil import HashInfo

    out = {}
    for k, v in attrs.items():
        if isinstance(v, HashInfo):
            out[k] = {"__hinfo__": [v.total_chunk_size,
                                    list(v.cumulative_shard_hashes)]}
        elif isinstance(v, bytes):
            out[k] = {"__b64__": _b64(v)}
        else:
            out[k] = v
    return out


def _attrs_restore(raw: dict) -> dict:
    from ceph_tpu_torch.osd.ecutil import HashInfo

    out = {}
    for k, v in raw.items():
        if isinstance(v, dict) and "__hinfo__" in v:
            out[k] = HashInfo(v["__hinfo__"][0], list(v["__hinfo__"][1]))
        elif isinstance(v, dict) and "__b64__" in v:
            out[k] = _unb64(v["__b64__"])
        else:
            out[k] = v
    return out


def _coll_of(pgid: str) -> str:
    pool, _, ps = pgid.partition(".")
    return f"pg_{int(pool)}_{int(ps)}"


def open_store(data_path: str, type_: str = "auto"):
    """(store, backend-name) over a stopped OSD's FileDB dir. `auto`
    probes for BlockStore's pinned-geometry row / block file, the way
    the reference sniffs the store type from the data dir."""
    db = FileDB(data_path)
    if type_ == "auto":
        type_ = (
            "blockstore"
            if db.get(b"bmt", b"geometry") is not None
            or os.path.exists(os.path.join(data_path, "block"))
            else "kstore"
        )
    if type_ == "blockstore":
        from ceph_tpu_torch.osd.blockstore import BlockStore

        return BlockStore(db), "blockstore"
    return KStore(db), "kstore"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="objectstore_tool")
    ap.add_argument("--data-path", required=True)
    ap.add_argument("--op", required=True,
                    choices=["list", "info", "get", "log", "export",
                             "import", "fsck"])
    ap.add_argument("--type", default="auto",
                    choices=["auto", "kstore", "blockstore"],
                    help="store backend (auto probes the data dir)")
    ap.add_argument("--deep", action="store_true",
                    help="fsck: re-read every blob against its stored "
                         "checksums")
    ap.add_argument("--pgid")
    ap.add_argument("--obj")
    ap.add_argument("--out")
    ap.add_argument("--file")
    args = ap.parse_args(argv)

    store, backend = open_store(args.data_path, args.type)
    db = store.db
    try:
        if args.op == "fsck":
            errors = store.fsck(deep=args.deep)
            print(json.dumps({
                "backend": backend,
                "deep": args.deep,
                "error_count": len(errors),
                "errors": errors,
            }, indent=2))
            return 1 if errors else 0
        if args.op == "list":
            colls = (
                [_coll_of(args.pgid)] if args.pgid
                else sorted(store.list_collections())
            )
            for coll in colls:
                for name in sorted(store.list_objects(coll)):
                    if name == PGMETA:
                        continue
                    print(json.dumps({"pgid": coll, "name": name}))
            return 0
        if args.op == "info":
            coll = _coll_of(args.pgid)
            attrs = store.getattrs(coll, args.obj)
            data = store.read(coll, args.obj)
            print(json.dumps({
                "name": args.obj,
                "size": len(data),
                "attrs": _attrs_jsonable(attrs),
                "omap_keys": len(store.omap_get(coll, args.obj)),
            }, indent=2))
            return 0
        if args.op == "get":
            data = store.read(_coll_of(args.pgid), args.obj)
            if args.out in (None, "-"):
                sys.stdout.buffer.write(data)
            else:
                with open(args.out, "wb") as f:
                    f.write(data)
            return 0
        if args.op == "log":
            omap = store.omap_get(_coll_of(args.pgid), PGMETA)
            entries = [
                json.loads(v) for k, v in sorted(omap.items())
                if k.startswith(b"log/")
            ]
            print(json.dumps({"log": entries}, indent=2))
            return 0
        if args.op == "export":
            coll = _coll_of(args.pgid)
            bundle = {"pgid": args.pgid, "objects": []}
            for name in sorted(store.list_objects(coll)):
                entry = {
                    "name": name,
                    "data": _b64(store.read(coll, name)),
                    "attrs": _attrs_jsonable(store.getattrs(coll, name)),
                    "omap": {
                        _b64(k): _b64(v)
                        for k, v in store.omap_get(coll, name).items()
                    },
                }
                bundle["objects"].append(entry)
            out = args.out or f"{args.pgid}.export"
            with open(out, "w") as f:
                json.dump(bundle, f)
            print(json.dumps(
                {"exported": len(bundle["objects"]), "to": out}
            ))
            return 0
        if args.op == "import":
            with open(args.file) as f:
                bundle = json.load(f)
            coll = _coll_of(bundle["pgid"])
            txn = Transaction()
            if not store.collection_exists(coll):
                txn.create_collection(coll)
            for entry in bundle["objects"]:
                txn.write(
                    coll, entry["name"], _unb64(entry["data"]),
                    attrs=_attrs_restore(entry["attrs"]),
                )
                if entry["omap"]:
                    txn.omap_setkeys(coll, entry["name"], {
                        _unb64(k): _unb64(v)
                        for k, v in entry["omap"].items()
                    })
            store.queue_transaction(txn)
            print(json.dumps(
                {"imported": len(bundle["objects"]),
                 "pgid": bundle["pgid"]}
            ))
            return 0
        return 2
    except StoreError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        # offline tooling must never mutate the store on the way out:
        # BlockStore.close() skips the deferred flush umount() would do
        if hasattr(store, "close"):
            store.close()
        else:
            db.close()


if __name__ == "__main__":
    sys.exit(main())
